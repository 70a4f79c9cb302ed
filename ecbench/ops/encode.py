"""The encode op: each stream encodes one sealed volume over and over, as
the volume server's VolumeEcShardsGenerate handler does: `write_ec_files`,
then `write_sorted_file_from_idx`.

Traffic parameters (ecbench/workloads/<cell>.json):

    volumes                  streams, one volume each, encoding at once
    volume_mb                the size of each sealed volume
    sample_slabs_per_volume  slabs of a kept round compared byte for byte

Every `.ecNN` file is a symlink to the null device: an encode writes 1.4
shard bytes (1.5 for RS(6,3)) per `.dat` byte, far more than a run may
write, so the shard bytes are taken from the pipeline's shard sink
(`sinks=`), which gets every data and parity row of every slab.

The sink counts every row of every slab: each round's slabs have to tile
its shards once, every row of each once. The rows of one row of the
encoder's layout in DIGEST_ONE_IN, drawn from the seed for each round, are
compared too: the sink copies their data rows (the pipeline recycles its
read buffers) and keeps their parity rows (views of a fresh array), and
the harness's verifier thread folds each into a digest, off the timed
path. Digesting every row cost the pipelines a quarter of their rate on
the card's host (the verifier could not keep up and held them back), so
the check takes the sample that the benchmark's rules allow. After the
window the plain reference encodes the same `.dat` files; every digest,
and the bytes of a few slabs of kept rounds, are held against it.
"""

from __future__ import annotations

import bisect
import os
import threading
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from ecbench import harness, volumes

COPIES_HELD = 256  # data-row copies waiting for the verifier, at most
DIGEST_ONE_IN = 16  # layout rows of a round whose slabs are digested


@dataclass
class Slab:
    nbytes: int
    seen: list[int]  # [k + m] rows received
    digests: np.ndarray | None = None  # [k + m, FOLD_BYTES / 8] uint64


@dataclass
class Round:
    """One encode of one volume."""

    volume: int
    started: float
    slabs: dict[int, Slab] = field(default_factory=dict)  # by shard offset
    samples: dict[int, np.ndarray] = field(default_factory=dict)
    stats: object = None  # the encode's EncodeStats
    sink_s: float = 0.0  # time the sink took on the pipeline's thread
    digested: int = 0  # slabs handed to the verifier


class DigestSink:
    """The encode's shard sink. On the pipeline's thread it counts each
    row, copies or keeps the rows of the digested slabs and hands them to
    the verifier, marks what the pipeline is doing and reports each slab
    once its last parity row is in; a round that is not recorded (the
    warm-up) counts nothing."""

    def __init__(self, op: "Traffic", rnd: Round, stream: str,
                 digest_rows: set[int], sample: set[int], record: bool):
        self._op = op
        self._run = op.run
        self._rnd = rnd
        self._stream = stream
        self._digest_rows = digest_rows  # layout rows, by start offset
        self._sample = sample
        self._record = record
        self._n = op.run.k + op.run.m

    def put(self, shard_id: int, shard_off: int, row, nbytes: int) -> None:
        t = time.perf_counter()
        run = self._run
        if shard_id == 0:
            run.timeline.mark(self._stream, "encode:data_rows")
        if self._record:
            slab = self._rnd.slabs.get(shard_off)
            if slab is None:
                slab = self._rnd.slabs[shard_off] = Slab(nbytes,
                                                         [0] * self._n)
                if self._op.row_start(shard_off) in self._digest_rows:
                    slab.digests = np.zeros(
                        (self._n, harness.FOLD_BYTES // 8), np.uint64)
                    self._rnd.digested += 1
            slab.seen[shard_id] += 1
            if slab.digests is not None:
                held = shard_id < run.k
                if held:
                    self._op.room.acquire()
                    row = np.array(row[:nbytes], np.uint8)
                run.verifier.submit(self._digest, slab, shard_id, shard_off,
                                    row, nbytes, held)
        if shard_id == run.k - 1:
            run.timeline.mark(self._stream, "encode:await_parity")
        elif shard_id == run.k:
            run.timeline.mark(self._stream, "encode:parity_rows")
        if shard_id == self._n - 1:
            run.window.done(run.dat_bytes_in(shard_off, nbytes),
                            self._n * nbytes)
            run.timeline.mark(self._stream, "encode:await_slab")
        self._rnd.sink_s += time.perf_counter() - t

    def _digest(self, slab: Slab, shard_id: int, shard_off: int, row,
                nbytes: int, held: bool) -> None:
        """On the verifier's thread."""
        try:
            slab.digests[shard_id] = harness.fold(row, nbytes)
            if shard_off in self._sample:
                got = self._rnd.samples.setdefault(
                    shard_off, np.zeros((self._n, nbytes), np.uint8))
                got[shard_id] = np.asarray(row[:nbytes], np.uint8)
        finally:
            if held:
                self._op.room.release()


class Traffic:
    name = "encode"

    def __init__(self, run: "harness.Run"):
        self.run = run
        traffic = run.cell.traffic
        self.n_samples = int(traffic.get("sample_slabs_per_volume", 1))
        self.room = threading.BoundedSemaphore(COPIES_HELD)
        self._starts = [int(x) for x in np.cumsum([0] + run.layout[:-1])]

    def row_start(self, shard_off: int) -> int:
        """Shard offset of the layout row that holds `shard_off`."""
        return self._starts[bisect.bisect_right(self._starts, shard_off) - 1]

    def set_up(self) -> None:
        run = self.run
        for v, base in enumerate(run.bases):
            volumes.write_volume(base, run.dat_bytes, run.volume_seed(v),
                                 run.dev)
            run.wrote(base + ".dat", base + ".idx")
            for s in range(run.k + run.m):
                os.symlink(os.devnull, run.geo.shard_file_name(base, s))

    def samples_of(self, v: int) -> set[int]:
        """Shard offsets of the slabs whose rows are copied whole: the
        first slabs of rows drawn from the seed."""
        starts = self._starts
        rng = np.random.default_rng(volumes.seed_of(self.run.seed, 2, v))
        picks = rng.choice(len(starts), size=min(self.n_samples, len(starts)),
                           replace=False)
        return {starts[p] for p in picks}

    def digest_rows(self, v: int, n: int, sample: set[int]) -> set[int]:
        """Layout rows (by start) of round n of stream v whose slabs are
        digested: one in DIGEST_ONE_IN, drawn from the seed, and the
        sampled slabs' rows."""
        rng = np.random.default_rng(volumes.seed_of(self.run.seed, 4, v, n))
        picks = rng.random(len(self._starts)) * DIGEST_ONE_IN < 1
        return {s for s, p in zip(self._starts, picks) if p} | {
            self.row_start(off) for off in sample}

    def round(self, v: int, record: bool) -> None:
        from seaweedfs_tpu_torch.storage import ec_files

        run = self.run
        stream = f"v{v + 1}"
        rnd = Round(v, time.perf_counter())
        n = run.rounds_of(v)
        sample = (self.samples_of(v) if record and n in run.kept_rounds(v)
                  else set())
        digest = self.digest_rows(v, n, sample) if record else set()
        run.timeline.mark(stream, "encode:open")
        rnd.stats = ec_files.write_ec_files(
            run.bases[v], run.coder, run.geo,
            sinks=DigestSink(self, rnd, stream, digest, sample, record))
        run.timeline.mark(stream, "encode:ecx")
        ec_files.write_sorted_file_from_idx(run.bases[v])
        run.timeline.mark(stream, "idle")
        run.wrote(run.bases[v] + ".ecx")
        if record:
            run.record(rnd)

    def expected_shards(self, v: int) -> np.ndarray:
        """[k + m, shard bytes] shards of volume v by the reference, from
        its `.dat`."""
        run = self.run
        img = np.fromfile(run.bases[v] + ".dat", dtype=np.uint8)
        data = volumes.data_shards(img, run.k, run.large, run.small)
        parity = run.reference.parity(torch.from_numpy(data).to(run.dev),
                                      run.cell.config).cpu().numpy()
        return np.concatenate([data, parity])

    def check(self) -> tuple[dict[str, int], int, int]:
        """-> (compared numbers, attempted, failed)."""
        run = self.run
        mismatched = missing = sampled = 0
        attempted = failed = 0
        n = run.k + run.m
        size = sum(run.layout)
        for v in range(run.n_volumes):
            mine = [r for r in run.rounds if r.volume == v]
            if not mine:
                continue
            want = self.expected_shards(v)
            folds: dict[tuple[int, int], np.ndarray] = {}
            for rnd in mine:
                at = 0
                for off in sorted(rnd.slabs):
                    slab = rnd.slabs[off]
                    attempted += 1
                    bad = off != at or any(c != 1 for c in slab.seen)
                    missing += int(bad)
                    at = off + slab.nbytes
                    wrong = 0
                    if slab.digests is not None:
                        key = (off, slab.nbytes)
                        if key not in folds:
                            folds[key] = np.stack(
                                [harness.fold(want[s, off:], slab.nbytes)
                                 for s in range(n)])
                        wrong = int((folds[key] != slab.digests)
                                    .any(axis=1).sum())
                    mismatched += wrong
                    failed += int(bad or wrong > 0)
                if at != size:
                    missing += 1
                for off, rows in rnd.samples.items():
                    sampled += int((rows != want[:, off:off + rows.shape[1]])
                                   .sum())
        return ({"shard_digests_mismatched": mismatched,
                 "slabs_missing": missing,
                 "sampled_bytes_mismatched": sampled}, attempted, failed)

    def lines(self, t0: float) -> list[str]:
        """What the sink cost the pipelines' threads in the window."""
        inside = [r for r in self.run.rounds if r.started >= t0]
        slabs = sum(len(r.slabs) for r in inside)
        digested = sum(r.digested for r in inside)
        spent = sum(r.sink_s for r in inside)
        return [f"the shard sink's time on the pipelines' threads, rounds "
                f"begun in the window: {spent} s over {slabs} slabs, "
                f"{digested} of them digested"]
