"""Spans and the device trace of one run, and their reduction
to the numbers the per-layer readers take.

Spans are the benchmark's own, around its calls into the program's
layers: a host clock that ends with ``torch.cuda.synchronize()``, and in
a traced run a ``torch.profiler.record_function`` of the same name, so a
device idle gap can be named by the span the host was in.  Spans inside
the program are for a later change.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time

import numpy as np

SPAN_PREFIX = "bench_port:"


class Spans:
    """Named host-clock spans, each ended by a device synchronize."""

    def __init__(self, device, traced: bool) -> None:
        self.device = device
        self.traced = traced
        self.seconds: dict[str, list[float]] = {}

    def sync(self) -> None:
        if self.device.type == "cuda":
            import torch
            torch.cuda.synchronize(self.device)

    @contextlib.contextmanager
    def __call__(self, name: str):
        rf = contextlib.nullcontext()
        if self.traced:
            from torch.profiler import record_function
            rf = record_function(SPAN_PREFIX + name)
        with rf:
            t0 = time.perf_counter()
            try:
                yield
            finally:
                self.sync()
                self.seconds.setdefault(name, []).append(
                    time.perf_counter() - t0)


@dataclasses.dataclass
class DeviceTrace:
    """What a profiled window leaves: device intervals (start, end, name)
    in ns, the benchmark's spans as (start, end, name), and the window."""

    device: list[tuple[int, int, str]]
    spans: list[tuple[int, int, str]]
    window_ns: tuple[int, int]

    def kernel_seconds(self, fragment: str) -> tuple[float, int]:
        """Summed device time and count of the operations whose name
        holds ``fragment``."""
        hits = [(e - s) for s, e, n in self.device if fragment in n]
        return sum(hits) / 1e9, len(hits)

    def busy_intervals(self) -> list[tuple[int, int]]:
        """The union of device activity, clipped to the window."""
        lo, hi = self.window_ns
        out: list[list[int]] = []
        for s, e, _ in sorted(self.device):
            s, e = max(s, lo), min(e, hi)
            if e <= s:
                continue
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return [(s, e) for s, e in out]

    def busy_seconds(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) / 1e9

    @property
    def window_seconds(self) -> float:
        return (self.window_ns[1] - self.window_ns[0]) / 1e9

    def _span_at(self, t: int) -> str:
        """The innermost benchmark span open at ``t`` ("outside spans"
        where none is)."""
        best = None
        for s, e, n in self.spans:
            if s <= t <= e and (best is None or e - s < best[1] - best[0]):
                best = (s, e, n)
        return best[2] if best else "outside spans"

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, and the longest
        idle gaps named by the span the host was in."""
        by_name: dict[str, int] = {}
        for s, e, n in self.device:
            by_name[n] = by_name.get(n, 0) + (e - s)
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        lo, hi = self.window_ns
        edges = [lo]
        for s, e in self.busy_intervals():
            edges += [s, e]
        edges.append(hi)
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        gaps.sort(key=lambda g: g[0] - g[1])
        return {"device_ops": [[n, t / 1e9] for n, t in ops],
                "idle_gaps": [[self._span_at((s + e) // 2), (e - s) / 1e9]
                              for s, e in gaps[:top]]}


@contextlib.contextmanager
def profiled(enabled: bool, sink: list):
    """Profile the block on the CPU and the card when ``enabled``; the
    reduced :class:`DeviceTrace` is appended to ``sink`` on exit."""
    if not enabled:
        yield
        return
    from torch.profiler import ProfilerActivity, profile
    import torch
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    prof = profile(activities=acts)
    prof.__enter__()
    t0 = time.time_ns()
    try:
        yield
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        t1 = time.time_ns()
        prof.__exit__(None, None, None)
        sink.append(_reduce(prof, (t0, t1)))


def _reduce(prof, window_ns) -> DeviceTrace:
    """Device intervals and the benchmark's spans from the profiler's raw
    events (kineto's clock: ns since the epoch)."""
    device, spans = [], []
    for ev in prof.profiler.kineto_results.events():
        name = ev.name()
        s, e = int(ev.start_ns()), int(ev.end_ns())
        on_device = str(ev.device_type()).endswith("CUDA")
        if ev.is_user_annotation():
            if not on_device and name.startswith(SPAN_PREFIX):
                spans.append((s, e, name[len(SPAN_PREFIX):]))
            continue
        if on_device:
            device.append((s, e, name))
    return DeviceTrace(device, spans, window_ns)


class KernelArgs:
    """Records the sizes of each ``sig_hash`` and ``seg_count`` launch the
    program makes through ``repro_torch.kernels.ops`` while active: the
    valid-row flags and the column masks of a signature launch, paired
    with the segment count that follows it.  Only tensor references are
    kept; sizes are read after the window."""

    def __init__(self) -> None:
        self.sig: list[tuple] = []
        self.seg: list[int] = []          # index of the sig launch before
        self._saved = None

    def __enter__(self):
        from repro_torch.kernels import ops
        self._saved = (ops.row_signature, ops.seg_boundaries)
        sig_fn, seg_fn = self._saved

        def row_signature(mat, valid=None, col_masks=None):
            self.sig.append((tuple(mat.shape), valid, col_masks))
            return sig_fn(mat, valid=valid, col_masks=col_masks)

        def seg_boundaries(sig_sorted):
            self.seg.append(len(self.sig) - 1)
            return seg_fn(sig_sorted)

        ops.row_signature, ops.seg_boundaries = row_signature, seg_boundaries
        return self

    def __exit__(self, *exc):
        from repro_torch.kernels import ops
        ops.row_signature, ops.seg_boundaries = self._saved
        return False

    def launches(self):
        """Per signature launch (valid rows N, each real candidate's
        column count, the union of their columns)."""
        out = []
        for shape, valid, masks in self.sig:
            n = int(valid.sum()) if valid is not None else shape[-2]
            if masks is None:
                k = shape[-1]
                c = shape[0] if len(shape) == 3 else 1
                out.append((n, (k,) * c, k))
                continue
            # the distinct non-empty masks: a bucket's padding candidates
            # are empty or repeat a real one
            m = masks.cpu().numpy() != 0
            real = np.unique(m[m.any(axis=1)], axis=0)
            out.append((n, tuple(int(r.sum()) for r in real),
                        int(real.any(axis=0).sum())))
        return out
