"""ElastiFormer self-distillation trainer of the port.

Wires the config registry, the frozen base model and the router tree
(random weights from ``--seed``), the distillation step with AdamW on the
routers, the deterministic data pipeline and the budget schedule
(``--budget``, ``--anneal-from``, ``--anneal-steps``: the roofline budget
solver per step, and its ragged bucket; a full-budget step takes the
identity path). Runs on the CUDA card unless ``--device cpu`` is given:

    python -m repro_torch.launch.train --arch qwen2-7b --variant full \\
        --steps 4 --seq-len 512 --batch 2 --budget 0.5 --anneal-from 1.0
    python -m repro_torch.launch.train --arch toy-lm --device cpu --steps 3
    python -m repro_torch.launch.train --arch qwen2-moe-a2.7b --variant smoke \
        --device cpu --steps 3 --seq-len 64 --batch 2

Each arch trains with ``configs.get_elastic``'s config: its registered
one (the native MoE ``qwen2-moe-a2.7b``: expert top-k over its 60 experts,
token routing, head top-k, LoRA), else the port's default (token routing
around attention and the MLP, head top-k, LoRA rank 1).

With ``--ckpt DIR`` the loop is the JAX trainer's fault-tolerant one
(``runtime/fault_tolerance.run_resilient``): it resumes from the latest
checkpoint in DIR, saves every ``save_every`` steps and at the end
(``checkpoint.Checkpointer``, in the JAX trainer's layout: a port
checkpoint resumes in the JAX trainer and the other way round), restores
and replays on a failure (``inject_failures`` injects them), and a
straggler watchdog flags slow steps. ``batch_at(step)``, the budget
schedule and the optimizer step are functions of the step, so a resumed
run is bit for bit the run that was not interrupted:

    python -m repro_torch.launch.train --arch toy-lm --device cpu \\
        --steps 8 --ckpt ckpt_toy        # again: resumes at step 8's end
"""
from __future__ import annotations

import argparse
import dataclasses
import logging
import time

import torch

from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import get_config, get_elastic
from repro_torch.core.policy import (as_spec_policy, capacity_anneal,
                                     ragged_bucket, solve_budget)
from repro_torch.data import LMDataPipeline
from repro_torch.device import resolve_device
from repro_torch.interop import train_state_from_tree, train_state_tree
from repro_torch.models import model_init, router_init, router_param_count
from repro_torch.optim import cosine_schedule
from repro_torch.optim.optimizer import tree_leaves, tree_map
from repro_torch.runtime.fault_tolerance import (FailureInjector,
                                                 StragglerWatchdog,
                                                 run_resilient)
from repro_torch.training import init_train_state, make_train_step

log = logging.getLogger("repro_torch.train")

def build_trainer(arch: str, *, variant: str = "full", lr: float = 1e-4,
                  total_steps: int = 1000, seq_len: int = 512,
                  global_batch: int = 32, remat: bool = True, seed: int = 0,
                  ecfg=None, device=None, params=None, routers=None,
                  n_layers=None):
    """Returns (cfg, ecfg, params, state, step_fn, pipe). ``params`` /
    ``routers`` reuse weights the caller already holds; otherwise both are
    drawn from a ``torch.Generator`` seeded with ``seed`` on ``device``.
    ``n_layers`` cuts the depth (the width stays the config's)."""
    device = resolve_device(device)
    cfg = get_config(arch, variant)
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    ecfg = ecfg or get_elastic(arch, cfg)
    gen = torch.Generator(device=device).manual_seed(seed)
    if params is None:
        params = model_init(gen, cfg, ecfg, device=device)
    rp = routers if routers is not None else router_init(gen, cfg, ecfg,
                                                         device=device)
    n_base = sum(t.numel() for t in tree_leaves(params))
    log.info("base params: %.3fM frozen; router params: %d (%.5f%%)",
             n_base / 1e6, router_param_count(rp),
             100 * router_param_count(rp) / max(1, n_base))
    state = init_train_state(rp)
    step_fn = make_train_step(cfg, ecfg, lr=cosine_schedule(lr, total_steps),
                              remat=remat, chunked=cfg.vocab_size > 0)
    pipe = LMDataPipeline(vocab=cfg.vocab_size, seq_len=seq_len,
                          global_batch=global_batch, seed=seed)
    return cfg, ecfg, params, state, step_fn, pipe


def policy_schedule(cfg, ecfg, *, seq_len: int, budget: float,
                    anneal_from=None, anneal_steps=None, total_steps: int,
                    device=None):
    """step -> (policy, bucket): the budget solver's policy (tensor leaves
    on ``device``) for the annealed budget of that step, and its ragged
    bucket (``routing.IDENTITY_BUCKET`` at full budget)."""
    spec, _ = as_spec_policy(ecfg)
    sched = capacity_anneal(
        anneal_from if anneal_from is not None else budget, budget,
        anneal_steps if anneal_steps is not None else total_steps)
    cache = {}

    def at(step: int):
        b = round(sched(step), 4)
        if b not in cache:
            pol = solve_budget(cfg, spec, b)
            bkt = (ragged_bucket(pol, seq_len, spec=spec)
                   if spec.routing_impl == "ragged" else None)
            cache[b] = (pol.to(device) if device is not None else pol, bkt)
        return cache[b]
    return at


def train(arch: str, *, variant: str = "smoke", total_steps: int = 100,
          seq_len: int = 128, global_batch: int = 8, lr: float = 1e-3,
          ckpt_dir=None, save_every: int = 25, inject_failures: tuple = (),
          seed: int = 0, budget=None, anneal_from=None, anneal_steps=None,
          device=None, log_every: int = 10, n_layers=None, params=None):
    """Runs ``total_steps`` distillation steps; returns (state, history,
    restarts, watchdog). ``history[i]`` is the metrics of step ``i`` (as
    floats) of the trajectory that stands: a step replayed after a
    restore overwrites its entry, and the steps before a resumed start
    are None. ``ckpt_dir=None`` trains without checkpoints (an injected
    failure then restarts from step 0). ``params`` reuses base weights the
    caller holds (cut to ``n_layers`` when that is given)."""
    if budget is None and (anneal_from is not None
                           or anneal_steps is not None):
        raise ValueError("--anneal-from/--anneal-steps require --budget "
                         "(the anneal target)")
    device = resolve_device(device)
    cfg, ecfg, params, state, step_fn, pipe = build_trainer(
        arch, variant=variant, lr=lr, total_steps=total_steps,
        seq_len=seq_len, global_batch=global_batch, seed=seed,
        device=device, n_layers=n_layers, params=params)
    policy_at = None if budget is None else policy_schedule(
        cfg, ecfg, seq_len=seq_len, budget=budget, anneal_from=anneal_from,
        anneal_steps=anneal_steps, total_steps=total_steps, device=device)
    ckpt = Checkpointer(ckpt_dir, keep=3) if ckpt_dir is not None else None
    box = {"state": state}
    history = [None] * total_steps

    def do_step(step: int) -> dict:
        batch = {"tokens": torch.as_tensor(pipe.batch_at(step),
                                           device=device)}
        pol, bkt = (None, None) if policy_at is None else policy_at(step)
        t0 = time.perf_counter()
        box["state"], m = step_fn(box["state"], params, batch, pol,
                                  bucket=bkt)
        m = {k: float(v) for k, v in m.items()}
        m["step_s"] = time.perf_counter() - t0
        m["bucket"] = bkt
        history[step] = m
        if step % log_every == 0 or step == total_steps - 1:
            log.info("step %d %s", step, m)
        return m

    def save(step: int):
        if ckpt is not None:      # the JAX trainer's tree and extra
            ckpt.save(step, train_state_tree(box["state"], cfg, ecfg),
                      extra={"step": step, "data": pipe.state(),
                             "opt_step": int(box["state"].opt.step)})

    def restore() -> int:
        latest = None
        if ckpt is not None:
            ckpt.wait()           # a save still being written counts
            latest = ckpt.latest_step()
        if latest is None:
            box["state"] = init_train_state(state.router_params)
            return 0
        loaded, extra = ckpt.restore(
            latest, train_state_tree(box["state"], cfg, ecfg))
        st = train_state_from_tree(loaded, extra["opt_step"], cfg, ecfg)
        # each leaf in an allocation of its own, as a step leaves them
        # (not a view into the stacked layers), in the live trees' key
        # order (the optimizer sums the gradient norm in that order): a
        # resumed step is the uninterrupted run's, bit for bit
        fresh = lambda live, got: tree_map(lambda _, t: t.clone(), live, got)
        cur = box["state"]
        box["state"] = st._replace(
            router_params=fresh(cur.router_params, st.router_params),
            opt=st.opt._replace(m=fresh(cur.opt.m, st.opt.m),
                                v=fresh(cur.opt.v, st.opt.v)))
        pipe.restore(extra["data"])
        return extra["step"]

    watchdog = StragglerWatchdog()
    _, restarts = run_resilient(
        start_step=restore(), total_steps=total_steps, do_step=do_step,
        save=save, restore=restore, save_every=save_every,
        injector=FailureInjector(tuple(inject_failures)), watchdog=watchdog)
    if ckpt is not None:
        ckpt.wait()
    return box["state"], history, restarts, watchdog


def main(argv=None):
    logging.basicConfig(level=logging.INFO)
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="toy-lm")
    ap.add_argument("--variant", default="smoke")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt", default=None,
                    help="checkpoint directory: resumes from its latest "
                         "step, saves every --save-every steps (default: "
                         "none, no checkpoints)")
    ap.add_argument("--save-every", type=int, default=25)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--budget", type=float, default=None,
                    help="target compute budget in (0,1]; capacities from "
                         "the roofline budget solver")
    ap.add_argument("--anneal-from", type=float, default=None,
                    help="start budget of the linear capacity anneal")
    ap.add_argument("--anneal-steps", type=int, default=None)
    ap.add_argument("--device", default=None,
                    help="'cpu' to run on the CPU (default: the CUDA card)")
    args = ap.parse_args(argv)
    _, history, restarts, _ = train(
        args.arch, variant=args.variant, total_steps=args.steps,
        seq_len=args.seq_len, global_batch=args.batch, lr=args.lr,
        ckpt_dir=args.ckpt, save_every=args.save_every, seed=args.seed,
        budget=args.budget, anneal_from=args.anneal_from,
        anneal_steps=args.anneal_steps, device=args.device, log_every=1)
    print("final:", history[-1], "restarts:", restarts)


if __name__ == "__main__":
    main()
