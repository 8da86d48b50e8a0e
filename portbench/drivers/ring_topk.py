"""Whole top-k jobs of the rows ring over a panel row-sharded on R cards,
back to back: ``stormtpu_torch.parallel.distributed_topk_neighbors(shard,
k, shard_axis="rows", measure="count")``, each rank's ``RowShard``
resident on its card.

This process is rank 0, on the run's device. It starts ranks 1 … R−1 (R
the configuration's ``ranks``) as spawned processes, rank r on card r,
which import neither jax nor stormtpu, and drives them over pipes:
set-up, a job, exit. Every rank joins one ``torchrun``-style group through
the program's own ``join_group`` (the environment, a free local port) and
makes only its own rows (``shard_rows``), on its own device, from the
chunks of the seeded panel that overlap them. A rank that fails, dies or
stays silent for ``SILENCE_S`` ends every rank and, unless the blocked
call here returns within ``GRACE_S``, this process too, so no run outlives
its error.

Checked: rank 0's answer (the whole result: the ring ends with an
all-gather) at rows drawn from the seed, every job, against the
reference's exact counts of those rows with every row, the panel made
again a chunk at a time and never whole."""

from __future__ import annotations

import dataclasses
import math
import multiprocessing.connection
import os
import queue
import socket
import threading
import time
import traceback

import numpy as np
import torch

from portbench import generate, harness, panel, roofline
from portbench.reference import compare, counts, forms

WARM = "warmup"
#: seconds a rank may stay silent while it owes an answer
SILENCE_S = 300.0
#: seconds the blocked call of this process gets to return after an abort
GRACE_S = 10.0
#: the largest panel (bits) whose control runs off the card
HOST_CONTROL_MAX_BITS = 1 << 34
#: what each rank's group joins by (``join_group`` reads the torchrun variables)
GROUP_ENV = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK")


def _sharded_form():
    """The program's sharded input form; raises where the program lacks it."""
    try:
        from stormtpu_torch.parallel import RowShard, shard_rows
    except ImportError as e:
        raise RuntimeError(f"the program has no row-sharded input form "
                           f"(stormtpu_torch.parallel.RowShard, shard_rows): {e}") from e
    return RowShard, shard_rows


def make_shard(seed: int, what: str, n: int, m_bits: int, mesh):
    """This rank's ``RowShard`` of the panel ``what``: its rows
    (``shard_rows``) made on its device from the overlapping chunks,
    padding rows zero."""
    RowShard, shard_rows = _sharded_form()
    row0, row1 = shard_rows(n, m_bits, mesh)
    words = torch.zeros((row1 - row0, generate.words_for_bits(m_bits)), dtype=torch.int32,
                        device=mesh.device)
    last = min(row1, n)
    end_chunk = math.ceil(last / generate.CHUNK_ROWS) if last > row0 else 0  # else all padding
    for c in range(row0 // generate.CHUNK_ROWS, end_chunk):
        a = c * generate.CHUNK_ROWS
        chunk = generate.words_chunk(seed, what, c, generate.chunk_rows(n, c), m_bits,
                                     mesh.device)
        lo, hi = max(a, row0), min(a + chunk.shape[0], last)
        words[lo - row0 : hi - row0] = chunk[lo - a : hi - a]
        del chunk
    return RowShard(words, row0, n, m_bits)


class Rank:
    """One rank's part: its group and mesh, a warm-up job on a small panel
    of the same widths (``warmup_rows_per_rank`` rows a rank: it builds the
    kernels and the communicators), then its resident shard."""

    def __init__(self, config: dict, traffic: dict, seed: int, device, log):
        from stormtpu_torch.parallel import make_row_mesh

        world = config["ranks"]
        self.mesh = make_row_mesh(world, device=device)
        self.k, self.shard_axis = traffic["k"], traffic["shard_axis"]
        m = config["m_bits"]
        t0 = time.perf_counter()
        warm = make_shard(seed, WARM, world * traffic["warmup_rows_per_rank"], m, self.mesh)
        for _ in range(traffic["warmup_units"]):
            self.job(warm)
        del warm
        _sync(device)
        t1 = time.perf_counter()
        self.shard = make_shard(seed, panel.PANEL, config["n"], m, self.mesh)
        _sync(device)
        log(f"warm-up {t1 - t0:.3f} s, shard of {self.shard.words.shape[0]} rows "
            f"from {self.shard.row0} made in {time.perf_counter() - t1:.3f} s")

    def job(self, shard=None):
        from stormtpu_torch.parallel import distributed_topk_neighbors

        return distributed_topk_neighbors(self.shard if shard is None else shard, self.k,
                                          mesh=self.mesh, shard_axis=self.shard_axis,
                                          measure="count")

    def close(self) -> None:
        import torch.distributed as dist

        self.shard = None
        if dist.is_initialized():
            dist.destroy_process_group()
        if self.mesh.device.type == "cuda":
            torch.cuda.empty_cache()


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _peak(device) -> int:
    return torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0


def _group_env(rank: int, world: int, port: int) -> dict:
    return {"MASTER_ADDR": "localhost", "MASTER_PORT": str(port), "WORLD_SIZE": str(world),
            "RANK": str(rank), "LOCAL_RANK": str(rank)}


def _watch_parent(ppid: int) -> None:
    """End this rank when the process that started it is gone."""
    while os.getppid() == ppid:
        time.sleep(1.0)
    os._exit(3)


def rank_main(rank: int, world: int, port: int, device_type: str, config: dict,
              traffic: dict, seed: int, conn) -> None:
    """Ranks 1 … R−1: join, set up, then a job for every "job" until
    "exit", then exit without ending the group."""
    threading.Thread(target=_watch_parent, args=(os.getppid(),), daemon=True).start()
    os.environ.update(_group_env(rank, world, port))
    try:
        device = torch.device(device_type, rank) if device_type == "cuda" else torch.device("cpu")
        if device.type == "cuda":
            torch.cuda.set_device(device)
        else:
            torch.set_num_threads(1)
        notes = []
        r = Rank(config, traffic, seed, device, notes.append)
        conn.send(("ready", notes))
        while True:
            cmd = conn.recv()
            if cmd == "exit":
                break
            t0 = time.perf_counter()
            r.job()
            _sync(device)
            conn.send(("done", time.perf_counter() - t0, _peak(device)))
        # the group ends with the process: destroying it here would wait for
        # rank 0 to destroy its own, which it does once every rank has gone
        conn.send(("bye", _peak(device)))
        conn.close()
        os._exit(0)
    except BaseException:  # reported to rank 0, which ends every rank
        try:
            conn.send(("error", traceback.format_exc()))
        finally:
            os._exit(1)


class Ranks:
    """Ranks 1 … R−1 seen from rank 0: their processes, their pipes, and a
    thread that reads every message and ends every rank on a failure, a
    death or a silence of ``SILENCE_S`` while an answer is owed."""

    def __init__(self, procs, conns, log):
        self.procs, self.conns, self.log = procs, conns, log
        self.inbox = [queue.Queue() for _ in conns]
        self.owed: dict = {}
        self.lock = threading.Lock()
        self.closing = False
        self.failure = None
        self.thread = threading.Thread(target=self._watch, daemon=True)
        self.thread.start()

    def send(self, msg) -> None:
        with self.lock:
            for i, c in enumerate(self.conns):
                c.send(msg)
                self.owed[i] = time.monotonic() + SILENCE_S

    def expect(self, what: str) -> list:
        """Each rank's next message, which must be ``what``."""
        out = []
        for i, box in enumerate(self.inbox):
            while True:
                if self.failure is not None:
                    raise RuntimeError(self.failure)
                try:
                    msg = box.get(timeout=1.0)
                    break
                except queue.Empty:
                    continue
            if msg[0] != what:
                raise RuntimeError(f"rank {i + 1} sent {msg[0]!r}, not {what!r}")
            out.append(msg[1:])
        return out

    def _watch(self) -> None:
        live = list(self.conns)
        while live and self.failure is None:
            for c in multiprocessing.connection.wait(live, timeout=1.0):
                i = self.conns.index(c)
                try:
                    msg = c.recv()
                except (EOFError, OSError):
                    live.remove(c)
                    if not self.closing:
                        self._abort(f"rank {i + 1} closed its pipe "
                                    f"(exit code {self.procs[i].exitcode})")
                        return
                    continue
                if msg[0] == "error":
                    self._abort(f"rank {i + 1} failed:\n{msg[1]}")
                    return
                with self.lock:
                    self.owed.pop(i, None)
                self.inbox[i].put(msg)
            now = time.monotonic()
            with self.lock:
                late = [i for i, t in self.owed.items() if now > t]
            if late:
                self._abort(f"rank(s) {[i + 1 for i in late]} silent for {SILENCE_S:.0f} s")
                return

    def _abort(self, why: str) -> None:
        self.failure = why
        self.log(f"[portbench] {why}\n[portbench] ending every rank")
        self.kill()
        deadline = time.monotonic() + GRACE_S
        while time.monotonic() < deadline and not self.closing:
            time.sleep(0.2)
        # rank 0 held in a collective that will not end (not a process
        # already on its way out, whose daemon ranks it ended itself)
        if not self.closing and threading.main_thread().is_alive():
            self.log("[portbench] rank 0 did not return: exiting")
            os._exit(3)

    def kill(self) -> None:
        for p in self.procs:
            if p.is_alive():
                p.kill()
        for p in self.procs:
            p.join(timeout=10)

    def close(self) -> list:
        """Ask every rank to exit and wait until each has gone; returns
        their peak device bytes."""
        peaks = []
        self.closing = True
        if self.failure is None:
            try:
                self.send("exit")
                peaks = [p for (p,) in self.expect("bye")]
            except (RuntimeError, OSError):
                pass
        self.kill()
        return peaks


@dataclasses.dataclass
class State:
    cell: object
    rank: object            # Rank, this process's
    ranks: object           # Ranks, the others
    saved_env: dict
    rows: np.ndarray
    answers: list           # (vals, idx) at the checked rows, a job each
    peaks: list             # peak device bytes of every rank


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def setup(cell) -> State:
    import importlib
    import multiprocessing as mp

    _sharded_form()  # before any rank starts
    c, mix = cell.config, cell.traffic
    panel.check_layout(c)
    world = c["ranks"]
    port = _free_port()
    # the children pickle their entry point by its importable name
    target = importlib.import_module("portbench.drivers.ring_topk").rank_main
    ctx = mp.get_context("spawn")
    procs, conns = [], []
    saved = {k: os.environ.get(k) for k in GROUP_ENV}
    ranks = None
    try:
        with cell.timed(f"ranks 1-{world - 1} started"):
            for rank in range(1, world):
                mine, theirs = ctx.Pipe()
                p = ctx.Process(target=target, args=(rank, world, port, cell.device.type, c, mix,
                                                     cell.seed, theirs), daemon=True)
                p.start()
                theirs.close()
                procs.append(p)
                conns.append(mine)
            ranks = Ranks(procs, conns, cell.log)
            with ranks.lock:
                ranks.owed = {i: time.monotonic() + SILENCE_S for i in range(world - 1)}
        os.environ.update(_group_env(0, world, port))
        with cell.timed("rank 0 joined, warmed up and made its shard"):
            rank0 = Rank(c, mix, cell.seed, cell.device,
                         lambda m: cell.log(f"[portbench]   rank 0: {m}"))
        with cell.timed("the other ranks ready"):
            for i, (notes,) in enumerate(ranks.expect("ready")):
                for m in notes:
                    cell.log(f"[portbench]   rank {i + 1}: {m}")
    except BaseException:
        if ranks is not None:
            ranks.close()
        else:
            for p in procs:
                p.kill()
        _restore(saved)
        raise
    rows = generate.pick(cell.seed, "check_rows", c["n"], mix["check_rows"])
    return State(cell, rank0, ranks, saved, rows, [], [])


def _restore(saved: dict) -> None:
    for k, v in saved.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v


def unit(state, index: int):
    state.ranks.send("job")
    with harness.span("distributed_topk_neighbors"):
        vals, idx = state.rank.job()
    state.answers.append((vals[state.rows].copy(), idx[state.rows].copy()))
    state.ranks.expect("done")
    return roofline.allpairs(state.cell.config["n"]), {}


def work(cell) -> tuple[float, float]:
    """Rank 0's share of one job's answer: a quarter (one rank's) of the
    operations and bytes of the panel's unordered pairs and its top-k
    output. The traced window sees rank 0's card only; the square ring
    computes each pair twice, once on each side, which this does not
    count."""
    c = cell.config
    ops, nbytes = roofline.dense_allpairs_work(c["n"], c["m_bits"], 8 * c["n"] * cell.traffic["k"])
    return ops / c["ranks"], nbytes / c["ranks"]


def release(state) -> None:
    # the other ranks first: this rank's group ends once theirs have
    peaks = state.ranks.close()
    state.peaks = [_peak(state.cell.device)] + peaks
    state.rank.close()
    state.rank = None
    _restore(state.saved_env)
    state.cell.log("[portbench]   peak device bytes by rank: "
                   + " ".join(str(p) for p in state.peaks))


def _rows_words(cell, rows: np.ndarray) -> torch.Tensor:
    """The checked rows' words, from the chunks that hold them."""
    c = cell.config
    out = torch.empty((rows.size, generate.words_for_bits(c["m_bits"])), dtype=torch.int32,
                      device=cell.device)
    chunk_of = rows // generate.CHUNK_ROWS
    for ch in np.unique(chunk_of):
        sel = np.flatnonzero(chunk_of == ch)
        words = generate.words_chunk(cell.seed, panel.PANEL, int(ch),
                                     generate.chunk_rows(c["n"], int(ch)), c["m_bits"],
                                     cell.device)
        local = torch.as_tensor(rows[sel] - ch * generate.CHUNK_ROWS, device=cell.device)
        out[torch.as_tensor(sel, device=cell.device)] = words[local]
    return out


def _reference_rows(cell, rows, precision: str) -> np.ndarray:
    c = cell.config
    chunks = generate.words_panel_device(cell.seed, panel.PANEL, c["n"], c["m_bits"],
                                         cell.device)
    return counts.row_counts(_rows_words(cell, rows), chunks, c["n"], precision)


def check(cell, state) -> dict:
    ref = _reference_rows(cell, state.rows, "float32")
    k = cell.traffic["k"]
    wrong = sum(compare.topk_rows_wrong(ref, state.rows, v, i, k, self_pairs=False)
                for v, i in state.answers)
    return {"rows_wrong": (wrong, 0)}


def control(cell) -> dict:
    """The reference in the program's place, its counts a bfloat16
    product: the readings it gives, judged as the program's are. A panel
    of more than ``HOST_CONTROL_MAX_BITS`` is refused off the card: its
    reference would take hours there."""
    c = cell.config
    if cell.device.type != "cuda" and c["n"] * c["m_bits"] > HOST_CONTROL_MAX_BITS:
        raise RuntimeError(f"the control of a {c['n']} x {c['m_bits']}-bit panel runs on the "
                           f"card (control.py --device cuda)")
    rows = generate.pick(cell.seed, "check_rows", cell.config["n"], cell.traffic["check_rows"])
    ref = _reference_rows(cell, rows, "float32")
    low = _reference_rows(cell, rows, "bfloat16")
    k = cell.traffic["k"]
    vals, idx = forms.topk_of(low, rows, k, self_pairs=False)
    return {"rows_wrong": compare.topk_rows_wrong(ref, rows, vals, idx, k, self_pairs=False)}
