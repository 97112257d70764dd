"""Weight interop: JAX-initialised toy-lm params and routers, flattened as the
checkpointer writes them, load into the port and come back bit for bit.

Also the shared set-up of the port's parity tests (``toy_pair``) and the
router-margin probe they assert with (``RouterMargins``).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # the suite runs one process per core

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint.checkpointer import _flatten, _unflatten_into  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core.policy import ElasticSpec as JaxSpec  # noqa: E402
from repro.models import model_init as jax_model_init  # noqa: E402
from repro.models import router_init as jax_router_init  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import routing as R  # noqa: E402
from repro_torch.core.policy import ElasticSpec  # noqa: E402
from repro_torch.interop import params_from_numpy, params_to_numpy  # noqa: E402

# the serving slice's elastic machinery: token routing around attention and
# the MLP, head top-k, LoRA rank 1 (no experts, no depth)
SPEC_KW = dict(mlp_token_routed=True, mha_token_routed=True,
               mha_head_routed=True, lora_rank=1)


def toy_pair(seed=0, dtype="float32", lora_b=0.05, spec_kw=SPEC_KW):
    """toy-lm built by the JAX package (kernels in interpret mode) and the
    same weights loaded into the port. LoRA B starts at zero; ``lora_b``
    fills it with N(0, lora_b) noise so the adapter path does work.
    ``spec_kw``: the ElasticSpec fields of both sides."""
    jcfg = dataclasses.replace(jax_get_config("toy-lm", "smoke"), dtype=dtype)
    tcfg = dataclasses.replace(get_config("toy-lm", "smoke"), dtype=dtype)
    jspec = JaxSpec(**spec_kw, kernel_backend="interpret")
    tspec = ElasticSpec(**spec_kw)
    key = jax.random.PRNGKey(seed)
    params = jax_model_init(key, jcfg, jspec)
    rp = jax_router_init(jax.random.fold_in(key, 1), jcfg, jspec)
    if lora_b:
        rng = np.random.default_rng(seed)
        rflat = {k: (rng.standard_normal(v.shape).astype(v.dtype) * lora_b
                     if "['lora']" in k and k.endswith("['b']") else v)
                 for k, v in _flatten(rp).items()}
        rp = jax.tree.map(jnp.asarray, _unflatten_into(rp, rflat))
    flat = _flatten({"params": params, "routers": rp})
    tparams, trp = params_from_numpy(flat, tcfg, tspec, device="cpu")
    return dict(jcfg=jcfg, jspec=jspec, params=params, rp=rp, flat=flat,
                tcfg=tcfg, tspec=tspec, tparams=tparams, trp=trp)


class RouterMargins:
    """Records, while installed, how far the port's routing decisions sit
    from their thresholds: |token logit - threshold logit| and the gap
    between the k-th and (k+1)-th head weight. JAX and the port agree to
    ~1e-6 on these values, so a margin well above that means both
    frameworks take the same decisions; a drifting seed fails loudly."""

    def __init__(self, monkeypatch, theta=0.5):
        self.token = np.inf
        self.head = np.inf
        thr = float(np.log(theta / (1 - theta)))
        tl, prw = R.token_logits, R.param_route_weights

        def token_logits(rp, x):
            lg = tl(rp, x)
            self.token = min(self.token, float((lg - thr).abs().min()))
            return lg

        def param_route_weights(rp, x, top_k, *a, **kw):
            w, m, aux = prw(rp, x, top_k, *a, **kw)
            srt = torch.sort(w, dim=-1, descending=True).values
            k = torch.as_tensor(top_k).to(torch.int64).clamp(1, w.shape[-1])
            k = k.reshape(tuple(k.shape) + (1,) * (w.dim() - k.dim()))
            k = k.expand(w.shape[:-1] + (1,))
            inner = k < w.shape[-1]
            if inner.any():
                kth = srt.gather(-1, k - 1)
                nxt = srt.gather(-1, k.clamp(max=w.shape[-1] - 1))
                gap = (kth - nxt)[inner]
                self.head = min(self.head, float(gap.min()))
            return w, m, aux

        monkeypatch.setattr(R, "token_logits", token_logits)
        monkeypatch.setattr(R, "param_route_weights", param_route_weights)

    def check(self, margin=1e-4):
        assert self.token > margin, f"a token router logit sits {self.token}"
        assert self.head > margin, f"a head top-k gap is {self.head}"


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_params_and_routers_round_trip(dtype):
    s = toy_pair(seed=3, dtype=dtype)
    back = params_to_numpy(s["tparams"], s["trp"], s["tcfg"], s["tspec"])
    assert sorted(back) == sorted(s["flat"])
    for k, want in s["flat"].items():
        got = back[k]
        if dtype == "bfloat16" and want.dtype.name == "bfloat16":
            assert got.dtype == np.float32     # numpy has no bf16: widened
            want = want.astype(np.float32)
        assert got.dtype == want.dtype, k
        np.testing.assert_array_equal(got, want, err_msg=k)


def test_layer_unstacking_follows_the_scan_layout():
    """Layer i of the port is scan[j][p] with i = p * period_len + j."""
    s = toy_pair(seed=1)
    wq = s["params"]["scan"][0]["attn"]["wq"]          # (P, D, H, Dh)
    for i, layer in enumerate(s["tparams"]["layers"]):
        np.testing.assert_array_equal(layer["attn"]["wq"].numpy(),
                                      np.asarray(wq[i]))
    b = s["rp"]["scan"][0]["tok_mlp"]["b"]             # stacked scalars (P,)
    assert s["trp"]["layers"][2]["tok_mlp"]["b"].shape == ()
    assert float(s["trp"]["layers"][2]["tok_mlp"]["b"]) == float(b[2])
