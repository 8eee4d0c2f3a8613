"""The port's entry points (``fqtool_tpu_torch/entry.py``) against
``__graft_entry__.py``.

``entry("cpu")`` must give the JAX ``entry()``'s jitted output on the same
example batch (the port's ``se_pipeline`` takes no ``real`` plane; JAX gets
it all true).  ``dryrun`` over three CPU devices must pass, and must fail
when the join of the parts is broken (the sum of the reductions replaced by
the first part's values).
"""

from __future__ import annotations

import importlib.util
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from fqtool_tpu_torch import entry as tentry
from fqtool_tpu_torch.dist import sharding
from fqtool_tpu_torch.pipeline.device import outputs_to_numpy

from .test_torch_pe_pipeline import assert_same_outputs

REPO = Path(__file__).resolve().parent.parent


def _graft_entry():
    spec = importlib.util.spec_from_file_location(
        "graft_entry", REPO / "__graft_entry__.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_entry_on_cpu_equals_jax_entry():
    import jax

    jfn, jargs = _graft_entry().entry()
    ref = jax.device_get(jax.jit(jfn)(*jargs))
    fn, args = tentry.entry("cpu")
    assert all(a.device.type == "cpu" for a in args)
    for a, b in zip(args, jargs[:5]):  # the same batch, without `real`
        np.testing.assert_array_equal(a.numpy(), b)
    assert_same_outputs(ref, outputs_to_numpy(fn(*args)))


def test_dryrun_over_three_cpu_devices(capsys):
    tentry.dryrun(3, ["cpu"] * 3)
    assert "equal a single-device run OK" in capsys.readouterr().out


def test_dryrun_fails_when_the_join_is_broken(monkeypatch, capsys):
    monkeypatch.setattr(sharding, "_reduce", lambda vals: np.asarray(vals[0]))
    with pytest.raises(AssertionError, match="SE step pre"):
        tentry.dryrun(3, ["cpu"] * 3)
    assert "OK" not in capsys.readouterr().out


def test_dryrun_needs_n_devices():
    with pytest.raises(RuntimeError, match="need 3 devices"):
        tentry.dryrun(3, ["cpu"] * 2)


def test_module_runs_entry_and_dryrun():
    env = dict(os.environ, PYTHONPATH=str(REPO) + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run([sys.executable, "-m", "fqtool_tpu_torch.entry",
                           "--devices", "cpu,cpu"], env=env, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "entry() ran on cpu" in proc.stdout
    assert "over 2 devices" in proc.stdout
