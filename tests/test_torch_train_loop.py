"""The port's fault-tolerant trainer (``repro_torch.launch.train`` with
checkpoints) on the CPU: tests/test_train_loop.py's cases, resume bit for
bit (``torch.equal``, where the JAX test allows rel=1e-5), and a JAX
trainer's checkpoint directory resumed by the port's trainer.

The JAX-resume case trains toy-lm in f32 in both packages (JAX on its jnp
oracles, ``kernel_backend="ref"``) with the port's default elastic config
for toy-lm (token routing around attention and the MLP, head top-k, LoRA
rank 1), patched into JAX's trainer: JAX's own default moefies toy-lm's
MLP into 16 experts, the port's does not. Its tolerances are
tests/test_torch_train.py's for port against JAX: metrics rtol=atol=1e-4,
router params and AdamW moments rtol=1e-3, atol=2e-5.
"""
import dataclasses
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # the suite runs one process per core

import jax  # noqa: E402

from repro.checkpoint.checkpointer import _flatten  # noqa: E402
from repro.configs import ElasticConfig as JaxElasticConfig  # noqa: E402
from repro.launch import train as jax_train  # noqa: E402
from repro_torch.checkpoint import Checkpointer, flatten  # noqa: E402
from repro_torch.configs import get_config, get_elastic  # noqa: E402
from repro_torch.data import LMDataPipeline  # noqa: E402
from repro_torch.interop import (params_from_numpy,  # noqa: E402
                                 train_state_to_numpy)
from repro_torch.launch import train as T  # noqa: E402
from repro_torch.runtime.fault_tolerance import StragglerWatchdog  # noqa: E402

KW = dict(seq_len=16, global_batch=4, budget=0.5, anneal_from=1.0,
          device="cpu")


def _same_state(a, b):
    fa = flatten([a.router_params, a.opt.m, a.opt.v, a.opt.step])
    fb = flatten([b.router_params, b.opt.m, b.opt.v, b.opt.step])
    assert sorted(fa) == sorted(fb)
    for k in fa:
        np.testing.assert_array_equal(fa[k], fb[k], err_msg=k)


def test_pipeline_state_restore():
    p = LMDataPipeline(vocab=64, seq_len=8, global_batch=4, seed=3)
    for _ in range(4):
        next(p)
    st = p.state()
    want = next(p)
    q = LMDataPipeline(vocab=64, seq_len=8, global_batch=4, seed=3)
    q.restore(st)
    np.testing.assert_array_equal(next(q), want)
    with pytest.raises(AssertionError, match="identity"):
        LMDataPipeline(vocab=64, seq_len=8, global_batch=4,
                       seed=4).restore(st)


def test_fault_tolerant_restart_is_bit_exact(tmp_path):
    """Failures at two steps: each restores the latest checkpoint and
    replays; the run ends in the clean run's routers, moments and losses,
    bit for bit."""
    clean, hc, r0, _ = T.train("toy-lm", total_steps=12, save_every=4,
                               ckpt_dir=str(tmp_path / "clean"), **KW)
    faulty, hf, r1, _ = T.train("toy-lm", total_steps=12, save_every=4,
                                ckpt_dir=str(tmp_path / "faulty"),
                                inject_failures=(5, 9), **KW)
    assert (r0, r1) == (0, 2)
    _same_state(clean, faulty)
    assert [h["loss"] for h in hc] == [h["loss"] for h in hf]
    assert Checkpointer(str(tmp_path / "faulty")).all_steps() == [4, 8, 12]


def test_a_second_run_resumes_from_the_directory(tmp_path):
    """A new ``train`` call on a directory whose latest step is 4 starts
    there (the steps before it are None in its history) and ends where the
    uninterrupted run ended."""
    full, hist, _, _ = T.train("toy-lm", total_steps=8, save_every=4,
                               ckpt_dir=str(tmp_path / "a"), **KW)
    shutil.copytree(tmp_path / "a", tmp_path / "b")
    shutil.rmtree(tmp_path / "b" / "step_0000000008")
    resumed, hr, restarts, _ = T.train("toy-lm", total_steps=8,
                                       save_every=4,
                                       ckpt_dir=str(tmp_path / "b"), **KW)
    assert restarts == 0
    assert hr[:4] == [None] * 4
    assert [h["loss"] for h in hr[4:]] == [h["loss"] for h in hist[4:]]
    _same_state(full, resumed)


def test_restore_without_a_checkpoint_starts_over(tmp_path):
    """With no checkpoint to restore (``ckpt_dir=None``, or an empty
    directory) a failure resets to the initial router state at step 0, as
    JAX's restore does; the replay then equals the clean run."""
    clean, hc, _, _ = T.train("toy-lm", total_steps=4, **KW)
    again, ha, r, _ = T.train("toy-lm", total_steps=4,
                              inject_failures=(2,), **KW)
    assert r == 1
    _same_state(clean, again)
    assert [h["loss"] for h in hc] == [h["loss"] for h in ha]
    late, _, r, _ = T.train("toy-lm", total_steps=4, save_every=8,
                            ckpt_dir=str(tmp_path), inject_failures=(3,),
                            **KW)
    assert r == 1 and Checkpointer(str(tmp_path)).all_steps() == [4]
    _same_state(clean, late)


def test_straggler_watchdog_flags_slow_steps():
    wd = StragglerWatchdog(threshold=2.0)
    for _ in range(5):
        wd.observe(0, 0.10)
    assert wd.observe(5, 0.50)
    assert len(wd.flagged) == 1
    assert wd.ewma == pytest.approx(0.10)


def test_trainer_cli_with_ckpt_on_the_cpu(tmp_path, capsys):
    """``python -m repro_torch.launch.train --ckpt DIR --device cpu``: a
    second run resumes the first's last checkpoint; without a card and
    without ``--device cpu`` it raises."""
    argv = ["--arch", "toy-lm", "--seq-len", "16", "--batch", "2",
            "--save-every", "2", "--ckpt", str(tmp_path), "--device", "cpu"]
    T.main(argv + ["--steps", "2"])
    T.main(argv + ["--steps", "4"])
    finals = [ln for ln in capsys.readouterr().out.splitlines()
              if ln.startswith("final:")]
    assert len(finals) == 2 and all(f.endswith("restarts: 0")
                                    for f in finals)
    assert Checkpointer(str(tmp_path)).all_steps() == [2, 4]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            T.main(argv[:-2] + ["--steps", "1"])


@pytest.mark.parametrize("arch,variant", [("toy-lm", "smoke"),
                                          ("qwen2-moe-a2.7b", "smoke")])
def test_trainer_cli_without_ckpt_writes_no_checkpoint(arch, variant,
                                                       tmp_path, monkeypatch,
                                                       capsys):
    """Without ``--ckpt`` the CLI trains without checkpoints: two archs run
    in turn from one working and temporary directory, each trains all its
    steps from the start (neither restores the other's tree), twice the
    same, and no checkpoint is written."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    monkeypatch.setattr("tempfile.tempdir", None)
    other = "qwen2-moe-a2.7b" if arch == "toy-lm" else "toy-lm"
    argv = ["--variant", variant, "--steps", "2", "--seq-len", "16",
            "--batch", "2", "--save-every", "1", "--device", "cpu"]
    for a in (arch, other, arch):
        T.main(["--arch", a] + argv)
    finals = [ln for ln in capsys.readouterr().out.splitlines()
              if ln.startswith("final:")]
    assert len(finals) == 3
    assert all(f.endswith("restarts: 0") and "'loss'" in f for f in finals)
    strip = lambda f: f.split("'step_s'")[0]
    assert strip(finals[0]) == strip(finals[2]) != strip(finals[1])
    assert not list(tmp_path.rglob("manifest.json"))
    assert not list(tmp_path.rglob("step_*"))


# --------------- a JAX trainer's directory, resumed by the port --------------

def _f32(get):
    return lambda *a, **kw: dataclasses.replace(get(*a, **kw),
                                                dtype="float32")


def test_port_resumes_a_jax_trainer_directory(tmp_path, monkeypatch):
    """JAX's ``train`` runs toy-lm to step 4; JAX's and the port's trainer
    each resume a copy of that directory to step 8 (the port given JAX's
    base weights through ``interop.params_from_numpy``). The final metrics,
    routers and AdamW moments agree within the stated tolerances. The
    budget anneals 0.75 -> 0.25, so every resumed step keeps fewer heads
    than all: where all are kept the head router's gradient is 0 in exact
    arithmetic and AdamW turns each framework's f32 noise into updates of
    +-lr (tests/test_torch_train.py's three-step test says the same)."""
    jcfg = dataclasses.replace(jax_train.get_config("toy-lm", "smoke"),
                               dtype="float32")
    tcfg = dataclasses.replace(get_config("toy-lm", "smoke"),
                               dtype="float32")
    tecfg = get_elastic("toy-lm", tcfg)
    jecfg = JaxElasticConfig(
        mlp_token_capacity=tecfg.mlp_token_capacity,
        mha_token_capacity=tecfg.mha_token_capacity,
        mha_head_topk=tecfg.mha_head_topk, lora_rank=tecfg.lora_rank,
        kernel_backend="ref")
    monkeypatch.setattr(jax_train, "get_config", _f32(jax_train.get_config))
    monkeypatch.setattr(jax_train, "get_elastic", lambda *a, **kw: jecfg)
    monkeypatch.setattr(T, "get_config", _f32(T.get_config))
    kw = dict(variant="smoke", seq_len=32, global_batch=2, budget=0.25,
              anneal_from=0.75, anneal_steps=8, save_every=4)
    jax_train.train("toy-lm", total_steps=4, ckpt_dir=str(tmp_path / "jax"),
                    **kw)
    shutil.copytree(tmp_path / "jax", tmp_path / "port")
    jstate, jm, jr, _ = jax_train.train(
        "toy-lm", total_steps=8, ckpt_dir=str(tmp_path / "jax"), **kw)
    jparams = jax_train.model_init(jax.random.PRNGKey(0), jcfg, jecfg)
    tparams, _ = params_from_numpy(_flatten(jparams), tcfg, tecfg,
                                   device="cpu")
    tstate, hist, tr, _ = T.train(
        "toy-lm", total_steps=8, ckpt_dir=str(tmp_path / "port"),
        params=tparams, device="cpu", **kw)
    assert jr == tr == 0
    assert hist[:4] == [None] * 4 and all(h is not None for h in hist[4:])
    for k in ("loss", "distill", "aux_load", "aux_topk", "sel_rate"):
        np.testing.assert_allclose(hist[-1][k], jm[k], rtol=1e-4, atol=1e-4,
                                   err_msg=k)
    got, step = train_state_to_numpy(tstate, tcfg, tecfg)
    want = _flatten({"router": jstate.router_params, "opt_m": jstate.opt.m,
                     "opt_v": jstate.opt.v})
    assert step == int(jstate.opt.step) == 8
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=1e-3, atol=2e-5,
                                   err_msg=key)
