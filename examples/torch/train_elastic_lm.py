"""End-to-end driver of the PyTorch port: fault-tolerant ElastiFormer
distillation (the port's counterpart of examples/train_elastic_lm.py).

Uses the port's trainer (``repro_torch.launch.train``): the frozen base
model, the distillation step with the chunked top-50 KL, async atomic
checkpoints in the JAX trainer's layout, the straggler watchdog, and an
*injected failure* to show the restart from the last checkpoint mid-run.
Trains on the synthetic Zipf-Markov corpus. Runs on the CUDA card unless
``--device cpu`` is given.

Run:   PYTHONPATH=src python examples/torch/train_elastic_lm.py --device cpu
       PYTHONPATH=src python examples/torch/train_elastic_lm.py \\
           --arch qwen2-7b --variant full --seq-len 512 --batch 2 --steps 20
Flags: --inject-failure (at 40 % of the steps), --fresh (clear --ckpt
       first; without it a second run resumes the first), --ckpt (default:
       repro_torch_example_<arch>_<variant> in the temporary directory)
"""
import argparse
import logging
import os
import shutil
import tempfile

from repro_torch.launch.train import train


def main():
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(message)s")
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="toy-lm")
    ap.add_argument("--variant", default="smoke")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--fresh", action="store_true",
                    help="clear checkpoint dir first")
    ap.add_argument("--inject-failure", action="store_true",
                    help="kill the loop at 40%% to demo restart")
    ap.add_argument("--device", default=None,
                    help="'cpu' to run on the CPU (default: the CUDA card)")
    args = ap.parse_args()
    ckpt = args.ckpt or os.path.join(
        tempfile.gettempdir(),
        f"repro_torch_example_{args.arch}_{args.variant}")
    if args.fresh:
        shutil.rmtree(ckpt, ignore_errors=True)

    inject = (int(args.steps * 0.4),) if args.inject_failure else ()
    state, history, restarts, watchdog = train(
        args.arch, variant=args.variant, total_steps=args.steps,
        seq_len=args.seq_len, global_batch=args.batch,
        ckpt_dir=ckpt, save_every=max(10, args.steps // 10),
        inject_failures=inject, device=args.device)
    print(f"\nfinal metrics: {history[-1]}")
    print(f"restarts survived: {restarts}")
    print(f"straggler watchdog: {len(watchdog.flagged)} slow steps flagged "
          f"{watchdog.flagged[:5]}")


if __name__ == "__main__":
    main()
