"""The plain reference: exact counts by plain torch and NumPy, and the
comparisons that decide ``correct``. It imports nothing of the program
(``stormtpu_torch``) and takes nothing the program made: it works from
the seeded inputs alone."""
