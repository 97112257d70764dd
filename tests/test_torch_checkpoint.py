"""The port's Checkpointer (``repro_torch.checkpoint``) against the JAX
package's: tests/test_checkpoint.py's cases on torch trees, and the files
each writes read by the other, bit for bit, on the CPU.

A checkpoint is ``<dir>/step_<step:010d>/shard_<host>.npz`` plus a
``manifest.json`` of the step, the caller's extra and a crc32 per array,
keyed by JAX's ``keystr`` paths; a bf16 leaf is stored widened to f32.
"""
import json
import os
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # the suite runs one process per core

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint import Checkpointer as JaxCheckpointer  # noqa: E402
from repro.checkpoint.checkpointer import _flatten  # noqa: E402
from repro.training import init_train_state as jax_init_state  # noqa: E402
from repro_torch.checkpoint import Checkpointer, flatten  # noqa: E402
from repro_torch.interop import (train_state_from_numpy,  # noqa: E402
                                 train_state_from_tree, train_state_tree)
from tests.test_torch_interop import toy_pair  # noqa: E402


def _tree(seed=0, scale=1.0):
    g = torch.Generator().manual_seed(seed)
    return {"a": torch.randn(8, 8, generator=g) * scale,
            "b": {"c": torch.arange(5, dtype=torch.float32) * scale},
            "l": [torch.ones(3, dtype=torch.int32), (torch.zeros(2, 2),)]}


def _equal(a, b):
    fa, fb = flatten(a), flatten(b)
    assert sorted(fa) == sorted(fb)
    for k in fa:
        assert fa[k].dtype == fb[k].dtype, k
        np.testing.assert_array_equal(fa[k], fb[k], err_msg=k)


def test_roundtrip(tmp_path):
    ck = Checkpointer(str(tmp_path))
    t = _tree()
    ck.save(3, t, extra={"step": 3}, blocking=True)
    assert ck.latest_step() == 3
    zeros = jax.tree.map(torch.zeros_like, t)
    got, extra = ck.restore(3, zeros)
    assert extra == {"step": 3}
    assert isinstance(got["l"][1], tuple)
    _equal(got, t)
    names = sorted(os.listdir(tmp_path / "step_0000000003"))
    assert names == ["manifest.json", "shard_0.npz"]


def test_keep_n_gc(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        ck.save(s, _tree(s, s), blocking=True)
    assert ck.all_steps() == [3, 4]


def test_corruption_detected(tmp_path):
    ck = Checkpointer(str(tmp_path))
    t = _tree()
    ck.save(1, t, blocking=True)
    man = os.path.join(str(tmp_path), "step_0000000001", "manifest.json")
    m = json.load(open(man))
    k = next(iter(m["checksums"]))
    m["checksums"][k] += 1
    json.dump(m, open(man, "w"))
    with pytest.raises(IOError, match="corruption"):
        ck.restore(1, t)


def test_async_save_nonblocking_and_latest_wins(tmp_path, monkeypatch):
    """``save`` returns before its write ends (the write waits on an event
    here), and of five async saves the last is the latest."""
    ck = Checkpointer(str(tmp_path), keep=5)
    gate = threading.Event()
    write = ck._write

    def slow(*a):
        gate.wait(10)
        write(*a)
    monkeypatch.setattr(ck, "_write", slow)
    ck.save(0, _tree(0, 0.0))
    assert ck.latest_step() is None          # still being written
    gate.set()
    for s in range(1, 5):
        ck.save(s, _tree(s, float(s)))       # async
    ck.wait()
    got, _ = ck.restore(4, _tree())
    np.testing.assert_allclose(got["b"]["c"].numpy(),
                               np.arange(5, dtype=np.float32) * 4.0)
    assert ck.all_steps() == [0, 1, 2, 3, 4]


def test_restore_onto_a_device(tmp_path):
    """``device=`` places every tensor (the counterpart of JAX's
    ``shardings=``); without it each leaf goes where its ``tree_like``
    leaf lives."""
    ck = Checkpointer(str(tmp_path))
    t = _tree()
    ck.save(7, t, blocking=True)
    got, _ = ck.restore(7, t, device="meta")
    assert all(x.device.type == "meta" for x in flatten_tensors(got))
    assert got["a"].shape == (8, 8) and got["l"][0].dtype == torch.int32
    got, _ = ck.restore(7, t)
    assert all(x.device.type == "cpu" for x in flatten_tensors(got))
    _equal(got, t)


def flatten_tensors(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in flatten_tensors(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in flatten_tensors(v)]
    return [tree]


def test_save_snapshots_before_returning(tmp_path, monkeypatch):
    """A tensor changed in place after ``save`` returns leaves the file as
    it was (on the CPU ``t.cpu()`` is the same storage: the save copies)."""
    ck = Checkpointer(str(tmp_path))
    gate = threading.Event()
    write = ck._write
    monkeypatch.setattr(ck, "_write", lambda *a: (gate.wait(10), write(*a)))
    t = _tree()
    want = {k: v.copy() for k, v in flatten(t).items()}
    ck.save(1, t)
    t["a"].add_(1.0)
    t["b"]["c"].zero_()
    gate.set()
    ck.wait()
    got, _ = ck.restore(1, t)
    for k, v in flatten(got).items():
        np.testing.assert_array_equal(v, want[k], err_msg=k)


def test_bf16_leaf_round_trips_bit_for_bit(tmp_path):
    g = torch.Generator().manual_seed(3)
    x = (torch.randn(33, 17, generator=g) * 1e3).to(torch.bfloat16)
    x[0, :4] = torch.tensor([float("inf"), -0.0, 1e-40, 3.0e38])
    ck = Checkpointer(str(tmp_path))
    ck.save(2, {"w": x, "f": x.float()}, blocking=True)
    with np.load(tmp_path / "step_0000000002" / "shard_0.npz") as z:
        assert z["['w']"].dtype == np.float32      # stored widened
        np.testing.assert_array_equal(z["['w']"], z["['f']"])
    got, _ = ck.restore(2, {"w": torch.zeros_like(x),
                            "f": torch.zeros(33, 17)})
    assert got["w"].dtype == torch.bfloat16
    assert torch.equal(got["w"].view(torch.int16), x.view(torch.int16))


def test_shape_or_key_mismatch_names_the_key(tmp_path):
    ck = Checkpointer(str(tmp_path))
    t = _tree()
    ck.save(1, t, blocking=True)
    bad = dict(t, b={"c": torch.zeros(6)})
    with pytest.raises(ValueError, match=r"\['b'\]\['c'\].*\(5,\) != \(6,\)"):
        ck.restore(1, bad)
    with pytest.raises(ValueError, match=r"no array at \['z'\]"):
        ck.restore(1, dict(t, z=torch.zeros(1)))


def test_same_files_as_jax_for_the_same_tree(tmp_path):
    """The same arrays saved by both checkpointers: the same file names,
    npz keys, manifest checksums and extra."""
    t = _tree(5)
    jt = jax.tree.map(lambda x: jnp.asarray(x.numpy()), t)
    Checkpointer(str(tmp_path / "port")).save(
        9, t, extra={"step": 9}, blocking=True)
    JaxCheckpointer(str(tmp_path / "jax")).save(
        9, jt, extra={"step": 9}, blocking=True)
    mans = [json.load(open(tmp_path / d / "step_0000000009" /
                           "manifest.json")) for d in ("port", "jax")]
    assert mans[0] == mans[1]
    assert sorted(mans[0]["checksums"]) == sorted(_flatten(jt))


# ---------------------- the trainer's tree, both ways ------------------------

@pytest.fixture(scope="module")
def trainer_state():
    """A JAX training state of toy-lm with random moments and step 4, and
    its flat arrays."""
    s = toy_pair(seed=0)
    jstate = jax_init_state(s["rp"])
    tree = {"router": jstate.router_params, "opt_m": jstate.opt.m,
            "opt_v": jstate.opt.v}
    rng = np.random.default_rng(7)
    tree = jax.tree.map(lambda a: jnp.asarray(rng.standard_normal(
        a.shape).astype(np.float32)), tree)
    return s, tree


def test_port_restores_a_jax_trainer_checkpoint(tmp_path, trainer_state):
    s, tree = trainer_state
    JaxCheckpointer(str(tmp_path)).save(
        4, tree, extra={"step": 4, "opt_step": 4}, blocking=True)
    want = train_state_from_numpy(_flatten(tree), 4, s["tcfg"], s["tspec"],
                                  device="cpu")
    like = train_state_tree(want, s["tcfg"], s["tspec"])
    like = jax.tree.map(torch.zeros_like, like)
    ck = Checkpointer(str(tmp_path))
    assert ck.latest_step() == 4
    loaded, extra = ck.restore(4, like)
    got = train_state_from_tree(loaded, extra["opt_step"], s["tcfg"],
                                s["tspec"])
    assert extra == {"step": 4, "opt_step": 4}
    assert got.opt.step.dtype == torch.int32 and int(got.opt.step) == 4
    for a, b in ((got.router_params, want.router_params),
                 (got.opt.m, want.opt.m), (got.opt.v, want.opt.v)):
        _equal(a, b)


def test_jax_restores_a_port_trainer_checkpoint(tmp_path, trainer_state):
    """The port saves a TrainState; JAX's restore verifies every checksum
    and returns the same arrays."""
    s, tree = trainer_state
    state = train_state_from_numpy(_flatten(tree), 6, s["tcfg"], s["tspec"],
                                   device="cpu")
    Checkpointer(str(tmp_path)).save(
        6, train_state_tree(state, s["tcfg"], s["tspec"]),
        extra={"step": 6, "opt_step": int(state.opt.step)}, blocking=True)
    jck = JaxCheckpointer(str(tmp_path))
    assert jck.latest_step() == 6
    got, extra = jck.restore(6, jax.tree.map(jnp.zeros_like, tree))
    assert extra == {"step": 6, "opt_step": 6}
    fg, fw = _flatten(got), _flatten(tree)
    assert sorted(fg) == sorted(fw)
    for k in fw:
        np.testing.assert_array_equal(fg[k], fw[k], err_msg=k)
