"""CLI: ``python -m repro_torch.analysis [--device cpu] [--json out.json] ...``

Exit status is 1 if and only if an unwaived error-severity finding
remains. Without ``--device`` it runs on the card, and raises when there
is none.
"""
from __future__ import annotations

import argparse
import os
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="Static lint of the port's serving and training entry "
                    "points and kernel launches (the rule catalog is the "
                    "package docstring)")
    ap.add_argument("--device", default=None,
                    help="cpu, or a CUDA device (default: the card)")
    ap.add_argument("--arch", default="toy-lm")
    ap.add_argument("--variant", default="smoke")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the config to this many layers")
    ap.add_argument("--dtype", default="float32",
                    help="the config's activation dtype (float32, bfloat16)")
    ap.add_argument("--kv-dtype", default="fp32",
                    choices=["fp32", "bf16", "int8"],
                    help="the serving engines' KV cache storage")
    ap.add_argument("--weight-dtype", default="fp32",
                    choices=["fp32", "bf16", "int8"],
                    help="the serving engines' base weight storage")
    ap.add_argument("--no-depth", action="store_true",
                    help="lint without the elastic depth router")
    ap.add_argument("--pass", dest="only", action="append", metavar="NAME",
                    help="run only this pass (repeatable)")
    ap.add_argument("--waive", action="append", default=[],
                    metavar="RULE[:TARGET-GLOB]")
    ap.add_argument("--waiver-file", default="analysis-waivers.txt",
                    help="waiver file (default: ./analysis-waivers.txt if "
                         "present)")
    ap.add_argument("--json", metavar="PATH",
                    help="write the machine-readable report ('-' = stdout)")
    ap.add_argument("-v", "--verbose", action="store_true",
                    help="include finding detail blocks in the table")
    args = ap.parse_args(argv)

    from repro_torch.analysis import (Waiver, build_bundle,
                                      load_waiver_file, run_all)

    waivers = [Waiver.parse(w, reason="--waive") for w in args.waive]
    if os.path.exists(args.waiver_file):
        waivers += load_waiver_file(args.waiver_file)
    bundle = build_bundle(device=args.device, arch=args.arch,
                          variant=args.variant, n_layers=args.layers,
                          dtype=args.dtype, kv_dtype=args.kv_dtype,
                          weight_dtype=args.weight_dtype,
                          depth=not args.no_depth)
    report = run_all(bundle, waivers=waivers, only=args.only)
    if args.json == "-":
        print(report.to_json())
    else:
        if args.json:
            with open(args.json, "w") as f:
                f.write(report.to_json())
        print(report.table(verbose=args.verbose))
    return 0 if report.ok else 1


if __name__ == "__main__":
    sys.exit(main())
