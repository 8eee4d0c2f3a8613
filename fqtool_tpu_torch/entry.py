"""Entry points of the port: the counterpart of ``__graft_entry__.py``.

``entry(device)`` returns the flagship step (the single-end per-read
pipeline, ``pipeline/se.py::se_pipeline``) with its example arguments on the
device.  ``dryrun(n, devices)`` runs one single-end and one paired-end step
(correction and merge on) with the rows split over ``n`` devices
(dist/sharding.py) and asserts that every output equals a single-device run
of the same step before it prints OK.

``python -m fqtool_tpu_torch.entry [--devices cuda:0,cuda:0]`` runs both;
the devices default to ``FQTOOL_TPU_TORCH_DEVICE`` (every visible CUDA
device), and the entry step runs on the first of them.
"""

from __future__ import annotations

import argparse
import functools
import sys

import numpy as np
import torch

ADAPTER_R1 = b"AGATCGGAAGAGCACACGTCTGAACTCCAGTCA"


def _example_batch(b=256, l=152, seed=0):
    rng = np.random.default_rng(seed)
    seq = rng.choice(np.frombuffer(b"ACGTN", np.uint8), size=(b, l)).astype(np.uint8)
    qual = rng.integers(33, 74, size=(b, l)).astype(np.uint8)
    lens = rng.integers(40, l + 1, size=(b,)).astype(np.int32)
    mask = np.arange(l)[None, :] < lens[:, None]
    seq = np.where(mask, seq, 0).astype(np.uint8)
    qual = np.where(mask, qual, 0).astype(np.uint8)
    return seq, qual, lens


def _flagship_params():
    from .config.options import Options
    opt = Options()
    opt.qual_filter.enabled = True
    opt.quality_cut.enable_front = True
    opt.quality_cut.enable_tail = True
    opt.polyg_trim.enabled = True
    opt.polyx_trim.enabled = True
    opt.update()
    return opt


def entry(device=None):
    """(fn, example_args): ``fn(*example_args)`` is the single-end pipeline
    on the example batch, its arguments (seq, qual, lens, start0, keep) on
    ``device`` (default cuda)."""
    from .pipeline.device import to_device
    from .pipeline.se import se_pipeline

    p = _flagship_params().kernel_params()
    seq, qual, lens = _example_batch()
    start0 = np.zeros_like(lens)
    keep = np.ones(lens.shape[0], bool)
    fn = functools.partial(se_pipeline, p=p, adapter_r1=ADAPTER_R1,
                           use_start0=False, with_kmer=False)
    args = to_device((seq, qual, lens, start0, keep),
                     torch.device(device or "cuda"))
    return fn, args


def assert_same_outputs(label: str, single: dict, sharded: dict) -> None:
    """Every output key, NamedTuple field, dtype and value of ``sharded``
    (numpy output dicts) equal to ``single``'s."""
    if sorted(single) != sorted(sharded):
        raise AssertionError(f"{label}: output keys {sorted(sharded)} differ "
                             f"from the single-device run's {sorted(single)}")
    for key, a in single.items():
        b = sharded[key]
        pairs = ([(f"{key}.{f}", x, y) for f, x, y in zip(a._fields, a, b)]
                 if isinstance(a, tuple) else [(key, a, b)])
        for name, x, y in pairs:
            if x is None or y is None:
                if x is not y:
                    raise AssertionError(f"{label} {name}: None on one side only")
                continue
            x, y = np.asarray(x), np.asarray(y)
            if x.dtype != y.dtype or x.shape != y.shape or not np.array_equal(x, y):
                raise AssertionError(
                    f"{label} {name}: {y.dtype}{y.shape} over the devices, "
                    f"{x.dtype}{x.shape} on one device, "
                    f"{int(np.sum(x != y)) if x.shape == y.shape else 'all'} "
                    "values differ")


def dryrun(n: int, devices=None) -> None:
    """One single-end and one paired-end step (b = 8n rows of 64 bases,
    seeds 1 and 2, correction and merge on) with the rows split over the
    first ``n`` of ``devices`` (default: the first n CUDA devices), each held
    against a single-device run of the same step on the first device."""
    from .dist.sharding import run_pe_sharded, run_se_sharded
    from .pipeline.pe import pe_pipeline_call
    from .pipeline.se import se_pipeline_call

    if devices is None:
        count = torch.cuda.device_count()
        if count < n:
            raise RuntimeError(f"need {n} CUDA devices, have {count}")
        devices = [f"cuda:{i}" for i in range(n)]
    if len(devices) < n:
        raise RuntimeError(f"need {n} devices, have {len(devices)}: {devices}")
    devices = [torch.device(d) for d in devices[:n]]

    opt = _flagship_params()
    opt.correction.enabled = True
    opt.merge_pe.enabled = True
    opt.merge_pe.out = "/dev/null"
    p1 = opt.kernel_params(is_r2=False)
    p2 = opt.kernel_params(is_r2=True)

    b, l = 8 * n, 64
    seq1, qual1, lens1 = _example_batch(b, l, seed=1)
    seq2, qual2, lens2 = _example_batch(b, l, seed=2)
    z = np.zeros(b, np.int32)
    ones = np.ones(b, bool)

    se = (seq1, qual1, lens1, z, ones)
    assert_same_outputs("SE step", se_pipeline_call(se, devices[0], p1,
                                                    adapter_r1=ADAPTER_R1).get(),
                        run_se_sharded(devices, *se, p1, adapter_r1=ADAPTER_R1))
    pe = (seq1, qual1, lens1, seq2, qual2, lens2, z, z, ones)
    assert_same_outputs("PE step", pe_pipeline_call(pe, devices[0], p1, p2).get(),
                        run_pe_sharded(devices, *pe, p1, p2))
    print(f"dryrun: SE+PE steps ran over {n} devices "
          f"({','.join(map(str, devices))}) and equal a single-device run OK")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--devices", default=None,
                    help="comma-separated torch devices (default: "
                         "FQTOOL_TPU_TORCH_DEVICE, every visible CUDA device)")
    args = ap.parse_args(argv)
    if args.devices:
        devices = [torch.device(d.strip()) for d in args.devices.split(",")]
    else:
        from .main import device_from_env
        devices = device_from_env()
    fn, example = entry(devices[0])
    out = fn(*example)
    if devices[0].type == "cuda":
        torch.cuda.synchronize(devices[0])
    print(f"entry() ran on {devices[0]}: {len(out)} outputs for "
          f"{example[0].shape[0]} reads")
    dryrun(len(devices), devices)
    return 0


if __name__ == "__main__":
    sys.exit(main())
