"""Multi-device data-parallel execution.

Counterpart of ``fqtool_tpu/dist/sharding.py``.  The only scaling axis of a
FASTQ preprocessor is the read axis, so a chunk's rows are split into
contiguous parts, one per device (``torch.tensor_split`` sizes: the first
``rows % n`` parts hold one row more), each part runs the pipeline on its
own device, and the outputs are joined back in row order.  The device list
is a plain list of ``torch.device`` (it may name one device more than once).
The port's chunks carry no padded rows, so nothing is padded; a part with no
rows is not launched.

The join goes by output key, never by shape: the keys of :data:`REDUCED` are
reductions over the chunk's rows and are summed field by field in int32
(what XLA's all-reduce does under ``jit`` in the JAX package); every other
output is per row and is concatenated, NamedTuple fields one by one, a
``None`` field staying ``None``.  A shape rule would be wrong: a k-mer
histogram is ``4**k`` long, ``correction_matrix`` 64 and a ``BatchStats``
plane ``[8, L]``, and a chunk may hold that many rows.
"""

from __future__ import annotations

import functools
from typing import Dict, List, Sequence

import numpy as np
import torch

from ..config.options import KernelParams
from ..pipeline.device import dispatch
from ..pipeline.pe import pe_pipeline
from ..pipeline.se import se_pipeline

# outputs that are reductions over the chunk's rows (summed across parts):
# every BatchStats, every k-mer histogram, the correction from->to matrix
REDUCED = frozenset({
    "pre", "post", "pre1", "pre2", "post1", "post2", "postM",
    "pre_kmer", "post_kmer", "pre1_kmer", "pre2_kmer", "post1_kmer",
    "post2_kmer", "postM_kmer", "correction_matrix",
})


def row_bounds(rows: int, parts: int) -> List[tuple]:
    """``(lo, hi)`` of each of ``parts`` contiguous parts of ``rows`` rows,
    with ``torch.tensor_split`` sizes."""
    q, r = divmod(rows, parts)
    bounds, lo = [], 0
    for k in range(parts):
        hi = lo + q + (k < r)
        bounds.append((lo, hi))
        lo = hi
    return bounds


def _reduce(vals: list) -> np.ndarray:
    """Sum of the parts' arrays in their own dtype (int32 wraps as XLA's
    int32 all-reduce does)."""
    return np.asarray(functools.reduce(np.add, vals))


def _join_key(key: str, vals: list, rows: List[int]):
    if key in REDUCED:
        if isinstance(vals[0], tuple):
            return type(vals[0])(*(_reduce(list(f)) for f in zip(*vals)))
        return _reduce(vals)
    if isinstance(vals[0], tuple):
        return type(vals[0])(*(None if f[0] is None else _concat(key, list(f), rows)
                               for f in zip(*vals)))
    return _concat(key, vals, rows)


def _concat(key: str, vals: list, rows: List[int]) -> np.ndarray:
    for v, n in zip(vals, rows):
        if v.shape[:1] != (n,):
            raise ValueError(f"sharded output {key!r} has shape {v.shape} for a "
                             f"part of {n} rows: not a per-row output, and not "
                             "in REDUCED")
    return np.concatenate(vals)


def join_outputs(parts: Sequence[Dict[str, object]], rows: Sequence[int]) -> dict:
    """The output dict of a whole chunk from its parts' (numpy) output dicts,
    in row order; ``rows`` holds each part's row count."""
    if len(parts) == 1:
        return dict(parts[0])
    return {key: _join_key(key, [p[key] for p in parts], list(rows))
            for key in parts[0]}


class ShardedResult:
    """Handle over one chunk dispatched in parts: ``get()`` waits on each
    part in turn (each on its own device's event), copies it out and joins
    the parts."""

    __slots__ = ("_parts", "_rows")

    def __init__(self, parts, rows):
        self._parts = parts
        self._rows = rows

    def get(self) -> dict:
        return join_outputs([p.get() for p in self._parts], self._rows)


def dispatch_sharded(devices: Sequence, body, arrays: Sequence[np.ndarray],
                     **kw) -> ShardedResult:
    """Dispatch ``body`` over the rows of ``arrays`` split across
    ``devices`` (pipeline/device.py::dispatch for each part); returns the
    handle over the joined chunk."""
    # the parts with rows are a prefix of the split; a chunk of no rows
    # still runs one (empty) part, which gives the outputs their shapes
    bounds = [(lo, hi) for lo, hi in row_bounds(len(arrays[0]), len(devices))
              if hi > lo] or [(0, 0)]
    parts = [dispatch(body, [a[lo:hi] for a in arrays], device, **kw)
             for device, (lo, hi) in zip(devices, bounds)]
    return ShardedResult(parts, [hi - lo for lo, hi in bounds])


def dispatch_on(devices: Sequence, body, arrays: Sequence[np.ndarray], **kw):
    """One chunk on ``devices``: split across them when there are several,
    else dispatched whole on the one."""
    if len(devices) > 1:
        return dispatch_sharded(devices, body, arrays, **kw)
    return dispatch(body, arrays, devices[0], **kw)


def _devices(devices) -> list:
    return [torch.device(d) for d in devices]


def run_se_sharded(devices, seq, qual, lens, start0, keep, p: KernelParams,
                   **kw) -> dict:
    """``se_pipeline`` on one chunk of numpy planes split over ``devices``;
    returns the joined output dict (numpy)."""
    return dispatch_sharded(_devices(devices), se_pipeline,
                            (seq, qual, lens, start0, keep), p=p, **kw).get()


def run_pe_sharded(devices, seq1, qual1, lens1, seq2, qual2, lens2, start1,
                   start2, keep, p: KernelParams, p2: KernelParams, **kw) -> dict:
    """``pe_pipeline`` on one chunk of numpy planes split over ``devices``;
    returns the joined output dict (numpy)."""
    return dispatch_sharded(
        _devices(devices), pe_pipeline,
        (seq1, qual1, lens1, seq2, qual2, lens2, start1, start2, keep),
        p=p, p2=p2, **kw).get()
