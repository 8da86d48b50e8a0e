"""``python -m stormtpu_torch``: the command line (``stormtpu_torch.cli``)."""

from stormtpu_torch.cli import main

if __name__ == "__main__":
    raise SystemExit(main())
