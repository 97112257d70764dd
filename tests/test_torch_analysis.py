"""repro_torch.analysis: each rule fires on a seeded defect and stays
silent on the fixed twin, through the pass's own function and through the
CLI (exit status 1); waivers silence a finding but still report it; the
real toy-lm entry points lint clean on the CPU with the package's
waivers. The counterpart of tests/test_analysis.py (without the SHARD-*
rules, which wait for ROADMAP item 11)."""
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # the suite runs one process per core

from repro_torch import analysis  # noqa: E402
from repro_torch.analysis import (Finding, Report, Waiver,  # noqa: E402
                                  donation, dtype_lint, host_sync,
                                  launch_lint, retrace, run_all)
from repro_torch.analysis.__main__ import main as cli  # noqa: E402
from repro_torch.analysis.graphs import (GraphBundle, build_bundle,  # noqa: E402
                                         call_entry)
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.training.serve import EntryPoint  # noqa: E402


class StubEngine:
    """A serving engine that builds ``counts`` forms whatever it serves."""

    def __init__(self, counts=None):
        self.counts = counts or {"prefill": 0, "decode": 2}
        self.kv_dtype = self.weight_dtype = "fp32"

    def submit(self, request):
        pass

    has_work = False

    def compile_counts(self):
        return dict(self.counts)


def _mini(entries: dict, engine=None) -> GraphBundle:
    """A bundle whose entry points are the given fixtures."""
    cfg = types.SimpleNamespace(name="fixture", dtype="float32", n_layers=0)
    return GraphBundle(cfg, None, None, None, engine or StubEngine(),
                       device=torch.device("cpu"), _entries=dict(entries))


def _rules(finds):
    return {f.rule for f in finds}


# ------------------------------ the seeded defects ----------------------------

def _value_dep(bad):
    def f(x, n):
        return x[:int(n)] * 2 if bad else x * n
    return EntryPoint(f, (torch.ones(8), torch.tensor(5)), {}, graphed=True)


def _py_scalar(bad):
    return EntryPoint(lambda x, s: x * s,
                      (torch.ones(4), 3 if bad else torch.tensor(3)), {},
                      graphed=True)


def _host_sync(bad):
    def f(x):
        return x * (float(x.sum()) if bad else x.sum())
    return EntryPoint(f, (torch.ones(4),), {})


def _host_operand(bad):
    x = np.zeros(3, np.float32) if bad else torch.zeros(3)
    return EntryPoint(lambda x: x, (x,), {})


def _inplace_missing(bad):
    def step(caches, row):
        if bad:
            caches["layers"][0]["k"] = caches["layers"][0]["k"] + row
        else:
            caches["layers"][0]["k"].add_(row)
    caches = {"layers": [{"k": torch.zeros(4, 8)}]}
    return EntryPoint(step, (caches, torch.ones(8)), {},
                      inplace=((0, "layers", 0, "k"),))


def _inplace_copy(bad):
    def step(caches):
        k = caches["layers"][0]["k"]
        if bad:           # a functional update: a whole new cache, copied in
            k.copy_(torch.where(torch.arange(4)[:, None] == 1, 1.0, k))
        else:
            k[1] = 1.0
    caches = {"layers": [{"k": torch.zeros(4, 8)}]}
    return EntryPoint(step, (caches,), {}, inplace=((0, "layers", 0, "k"),))


def _upcast(bad):
    n = 512 if bad else 8
    return EntryPoint(lambda x: x.float() + 1.0,
                      (torch.zeros(n, n, dtype=torch.bfloat16),), {})


def _wide(bad):
    return EntryPoint(lambda x: x.double() if bad else x * 2,
                      (torch.zeros(4),), {})


def _quant_hbm(bad):
    n = 512 if bad else 8
    return EntryPoint(lambda q, s: q.float() * s,
                      (torch.zeros(n, n, dtype=torch.int8), torch.ones(())),
                      {})


def _decode_args(t_dtype):
    B, H, K, Dh, L = 2, 4, 2, 32, 16
    return (torch.randn(B, 1, H, Dh), torch.randn(B, L, K, Dh),
            torch.randn(B, L, K, Dh),
            torch.arange(L, dtype=torch.int32).expand(B, L).contiguous(),
            torch.tensor([5, 9], dtype=t_dtype))


def _control(bad):
    args = _decode_args(torch.int64 if bad else torch.int32)
    return EntryPoint(ops.decode_attention, args, {})


ENTRY_DEFECTS = {   # rule -> (pass, fixture(bad) -> EntryPoint)
    "RETRACE-VALUE-DEP": ("retrace", _value_dep),
    "RETRACE-PY-SCALAR": ("retrace", _py_scalar),
    "HOST-SYNC": ("host_sync", _host_sync),
    "HOST-OPERAND": ("host_sync", _host_operand),
    "INPLACE-MISSING": ("donation", _inplace_missing),
    "INPLACE-COPY": ("donation", _inplace_copy),
    "DTYPE-UPCAST": ("dtype", _upcast),
    "DTYPE-WIDE": ("dtype", _wide),
    "DTYPE-QUANT-HBM": ("dtype", _quant_hbm),
    "LAUNCH-CONTROL": ("launch", _control),
}
PASS_RUN = {"retrace": retrace.run, "host_sync": host_sync.run,
            "donation": donation.run, "dtype": dtype_lint.run,
            "launch": launch_lint.run}


@pytest.fixture
def no_kernel_examples(monkeypatch):
    """The launch pass over the fixture's entries only."""
    import repro_torch.kernels as K
    monkeypatch.setattr(K, "analyzable_kernels", lambda: {})


@pytest.mark.parametrize("rule", sorted(ENTRY_DEFECTS))
def test_rule_fires_on_defect_and_not_on_fix(rule, no_kernel_examples):
    pname, make = ENTRY_DEFECTS[rule]
    bad = PASS_RUN[pname](_mini({"serve_x": make(True)}))
    assert rule in _rules(bad), bad
    good = PASS_RUN[pname](_mini({"serve_x": make(False)}))
    assert rule not in _rules(good), good


@pytest.mark.parametrize("rule", sorted(ENTRY_DEFECTS))
def test_cli_exits_1_on_defect(rule, monkeypatch, capsys,
                               no_kernel_examples):
    pname, make = ENTRY_DEFECTS[rule]
    for bad, want in ((True, 1), (False, 0)):
        monkeypatch.setattr(analysis, "build_bundle",
                            lambda **kw: _mini({"x": make(bad)}))
        assert cli(["--device", "cpu", "--pass", pname]) == want
    assert rule in capsys.readouterr().out


def test_quant_hbm_exempts_training_and_the_kernels():
    """DTYPE-QUANT-HBM: the training step is exempt, and an int8 widening
    inside a kernel wrapper (the plain version of an int8 ``fused_mlp``)
    never reaches the recorder: the wrapper is the allowlist."""
    from repro_torch.models.quant import quantize_weight
    train = dtype_lint.findings_for(
        "train", call_entry(_quant_hbm(True)).records)
    assert "DTYPE-QUANT-HBM" not in _rules(train)
    D, F = 256, 512
    (wi, si), (wo, so) = (quantize_weight(torch.randn(*s), (-2,))
                          for s in ((D, F), (F, D)))
    ep = EntryPoint(lambda x: ops.fused_mlp(x, wi, wo, None, wi_scale=si,
                                            wo_scale=so, act="gelu"),
                    (torch.randn(1, 4, D),), {})
    assert dtype_lint.findings_for("decode", call_entry(ep).records) == []


def test_quant_hbm_names_a_widened_weight():
    """A widened tensor of the entry's params tree is reported at
    ``<entry>.weights`` (the package waives the engine's weight widening,
    PERF.md bottleneck (1)); a widened cache is reported at the entry and
    stays an error."""
    params = {"w": torch.zeros(512, 512, dtype=torch.int8)}
    cache = torch.zeros(512, 512, dtype=torch.int8)
    ep = EntryPoint(lambda p, c: (p["w"].float(), c.float()),
                    (params, cache), {})
    finds = dtype_lint.run(_mini({"decode": ep}))
    assert sorted(f.target for f in finds) == ["serve.decode",
                                               "serve.decode.weights"]
    r = Report()
    r.extend("dtype", finds, analysis.WAIVERS)
    assert [f.target for f in r.findings] == ["serve.decode"]
    assert [f.target for f, _ in r.waived] == ["serve.decode.weights"]


def test_compile_count_rule():
    bad = retrace.workload(_mini({}, StubEngine({"prefill": 1,
                                                 "decode": 3})))
    assert _rules(bad) == {"RETRACE-COMPILE-COUNT"}
    assert retrace.workload(_mini({}, StubEngine())) == []


def _geo(**kw):
    geo = {"body": "cuda_core", "launches": [
        {"kernel": "k", "grid": (2, 1, 1), "block": 256, "smem": 1024}],
        "tiles": [("q", (128, 64), (64, 64), (2, 1))]}
    geo.update(kw)
    return geo


def test_launch_oob_and_smem_on_a_bad_geometry():
    args = {"q": torch.zeros(1)}
    assert launch_lint.verify_call("k", "flash_attention", args, _geo()) == []
    oob = launch_lint.verify_call("k", "flash_attention", args, _geo(
        tiles=[("q", (128, 64), (64, 64), (3, 1))]))     # a tile past the end
    assert _rules(oob) == {"LAUNCH-OOB"}
    short = launch_lint.verify_call("k", "flash_attention", args, _geo(
        tiles=[("q", (129, 64), (64, 64), (2, 1))]))     # a row uncovered
    assert _rules(short) == {"LAUNCH-OOB"}
    grid = launch_lint.verify_call("k", "flash_attention", args, _geo(
        launches=[{"kernel": "k", "grid": (1, 70000, 1), "block": 256,
                   "smem": 0}]))
    assert _rules(grid) == {"LAUNCH-OOB"}
    smem = launch_lint.verify_call("k", "flash_attention", args, _geo(
        launches=[{"kernel": "k", "grid": (1, 1, 1), "block": 256,
                   "smem": 300_000}]))
    assert _rules(smem) == {"LAUNCH-SMEM"}


@pytest.mark.parametrize("D,F,rules", [(96, 128, {"LAUNCH-ALIGN"}),
                                       (128, 256, set())])
def test_launch_align_warns_on_a_narrow_bf16_mlp(D, F, rules):
    x = torch.randn(1, 8, D, dtype=torch.bfloat16)
    w = lambda a, b: torch.randn(a, b, dtype=torch.bfloat16)
    with ops.recording(cost=False) as calls:
        ops.fused_mlp(x, w(D, F), w(F, D), w(D, F))
    finds = launch_lint.check_call("k", calls[0])
    assert _rules(finds) == rules
    assert all(f.severity == "warning" for f in finds)


def test_every_kernel_form_has_a_sound_launch_statement():
    """Each representative call's statement: in bounds, within shared
    memory, and the narrow bf16 expert width on the CUDA-core body."""
    from repro_torch.kernels import analyzable_kernels
    for name, build in analyzable_kernels().items():
        fn, args, kw = build("cpu")
        with ops.recording(cost=False) as calls:
            fn(*args, **kw)
        assert len(calls) == 1, name
        rules = _rules(launch_lint.check_call(name, calls[0]))
        assert rules == ({"LAUNCH-ALIGN"} if name == "moe_gmm_bf16_narrow"
                         else set()), (name, rules)


# ------------------------------ waivers / report ------------------------------

def test_waivers_silence_but_still_report():
    r = Report()
    finds = [Finding("RULE-A", "serve.decode", "boom"),
             Finding("RULE-B", "kernels.moe_gmm", "bang")]
    r.extend("p", finds, [Waiver.parse("RULE-A:serve.*", reason="known")])
    assert [f.rule for f in r.findings] == ["RULE-B"]
    assert [f.rule for f, _ in r.waived] == ["RULE-A"]
    assert not r.ok
    assert "(waived: known)" in r.table()
    r2 = Report()
    r2.extend("p", finds, [Waiver("RULE-A"), Waiver("RULE-B")])
    assert r2.ok and len(r2.waived) == 2
    assert "2 waived" in r2.table()


def test_every_package_waiver_has_a_reason():
    assert analysis.WAIVERS and all(w.reason for w in analysis.WAIVERS)


# ------------------------------ the real entry points -------------------------

@pytest.fixture(scope="module")
def toy_bundle():
    return build_bundle(device="cpu")


def test_toy_entry_points_lint_clean(toy_bundle):
    report = run_all(toy_bundle)
    assert report.ok and not report.findings, report.table(verbose=True)
    assert set(report.passes) == {"retrace", "host_sync", "donation",
                                  "dtype", "launch"}
    assert set(report.meta["entries"]) == {"admit", "decode", "paged_chunk",
                                           "paged_decode", "train"}


def test_cli_on_the_toy_config(toy_bundle, monkeypatch, capsys):
    built = {}

    def bundle(**kw):           # the CLI's bundle, built once per module
        built.update(kw)
        return toy_bundle
    monkeypatch.setattr(analysis, "build_bundle", bundle)
    assert cli(["--device", "cpu"]) == 0
    assert built["device"] == "cpu" and built["arch"] == "toy-lm"
    out = capsys.readouterr().out
    for w in analysis.WAIVERS:
        if w.rule in ("LAUNCH-ALIGN", "LAUNCH-CONTROL"):   # toy-lm's findings
            assert w.reason in out


def test_cli_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli([])


def test_entry_points_share_the_live_bodies(toy_bundle):
    """The decode and chunk entry points are the bodies the engine runs:
    calling one on copies writes the copies."""
    b = toy_bundle
    for name in ("decode", "paged_chunk"):
        ep = b.entries()[name]
        tr = call_entry(ep)
        assert all(c.same_storage and c.version_moved for c in tr.inplace)
        assert any(isinstance(r, ops.KernelCall) for r in tr.records)
    eng = b.engine
    assert eng.entry_points()["decode"].fn.__func__ \
        is type(eng)._decode_fn
