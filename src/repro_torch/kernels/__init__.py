"""The port's hand-written CUDA kernels, their wrappers and plain versions."""
from __future__ import annotations


def analyzable_kernels() -> dict:
    """name -> ``make(device) -> (fn, args, kwargs)``: one representative
    call of each kernel form at toy widths, the enumeration the launch
    verifier (``repro_torch.analysis.launch_lint``) walks, as the JAX
    package's ``analyzable_kernels`` is for its Pallas kernels: f32 on the
    CUDA-core bodies, bf16 at widths that are multiples of 64 on the tensor
    cores, the int8 operand forms, and a bf16 ``moe_gmm`` at an expert
    width that is no multiple of 64 (``LAUNCH-ALIGN``). A new kernel is
    added here once and inherits the gates."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.models.quant import quantize_kv, quantize_weight

    def rnd(gen, *shape, dtype=torch.float32, device=None, scale=1.0):
        return (torch.randn(*shape, generator=gen) * scale).to(
            device=device, dtype=dtype)

    def flash(dtype, Dh):
        def build(device):
            g = torch.Generator().manual_seed(0)
            B, S, H, K = 2, 80, 4, 2
            q = rnd(g, B, S, H, Dh, dtype=dtype, device=device)
            k = rnd(g, B, S, K, Dh, dtype=dtype, device=device)
            v = rnd(g, B, S, K, Dh, dtype=dtype, device=device)
            valid = (torch.rand(B, S, generator=g) < 0.8).to(device)
            return ops.flash_attention, (q, k, v, valid,
                                         torch.tensor([80, 50], device=device,
                                                      dtype=torch.int32)), {}
        return build

    def mlp(dtype, D, F, int8=False, routed=False):
        def build(device):
            g = torch.Generator().manual_seed(1)
            B, T = 2, 24
            wdt = torch.float32 if int8 else dtype
            ws = [rnd(g, D, F, dtype=wdt, device=device, scale=D ** -0.5),
                  rnd(g, F, D, dtype=wdt, device=device, scale=F ** -0.5),
                  rnd(g, D, F, dtype=wdt, device=device, scale=D ** -0.5)]
            scales = {}
            if int8:
                (ws[0], s0), (ws[1], s1), (ws[2], s2) = (
                    quantize_weight(w, (-2,)) for w in ws)
                scales = dict(wi_scale=s0, wo_scale=s1, wg_scale=s2)
            cnt = torch.tensor([T, T // 2], device=device, dtype=torch.int32)
            if routed:
                x = rnd(g, B, 2 * T, D, dtype=dtype, device=device)
                idx = torch.stack([torch.randperm(2 * T, generator=g)[:T]
                                   for _ in range(B)]).to(device)
                return ops.fused_mlp_routed, (x, idx, *ws[:2], ws[2], None,
                                              cnt), scales
            x = rnd(g, B, T, D, dtype=dtype, device=device)
            return ops.fused_mlp, (x, *ws[:2], ws[2], None, cnt), scales
        return build

    def gmm(dtype, D, Fe):
        def build(device):
            g = torch.Generator().manual_seed(2)
            B, E, C = 1, 4, 16
            x = rnd(g, B, E, C, D, dtype=dtype, device=device)
            wi = rnd(g, E, D, Fe, dtype=dtype, device=device, scale=D ** -0.5)
            wg = rnd(g, E, D, Fe, dtype=dtype, device=device, scale=D ** -0.5)
            wo = rnd(g, E, Fe, D, dtype=dtype, device=device,
                     scale=Fe ** -0.5)
            cnt = torch.tensor([[16, 5, 0, 9]], device=device,
                               dtype=torch.int32)
            return ops.moe_gmm, (x, wi, wo, wg, None, cnt), {}
        return build

    def decode(dtype, paged=False, int8=False):
        def build(device):
            g = torch.Generator().manual_seed(3)
            B, H, K, Dh, L, ps = 2, 4, 2, 32, 48, 8
            q = rnd(g, B, 1, H, Dh, dtype=dtype, device=device)
            shape = (B * L // ps + 1, ps, K, Dh) if paged else (B, L, K, Dh)
            k, v = rnd(g, *shape), rnd(g, *shape)
            sc = {}
            if int8:
                (k, ks), (v, vs) = quantize_kv(k), quantize_kv(v)
                sc = dict(kscale=ks.to(device), vscale=vs.to(device))
            else:
                k, v = k.to(dtype), v.to(dtype)
            k, v = k.to(device), v.to(device)
            t = torch.tensor([30, 41], device=device, dtype=torch.int32)
            if paged:
                P = L // ps
                table = torch.arange(B * P, dtype=torch.int32).reshape(
                    B, P).to(device)
                pvalid = (torch.rand(shape[:2], generator=g) < 0.8).to(device)
                return ops.paged_decode_attention, (q, k, v, table, t,
                                                    pvalid), sc
            pos = torch.arange(L, dtype=torch.int32).expand(B, L) \
                .contiguous().to(device)
            valid = (torch.rand(B, L, generator=g) < 0.8).to(device)
            return ops.decode_attention, (q, k, v, pos, t, valid), sc
        return build

    f32, bf16 = torch.float32, torch.bfloat16
    return {
        "flash_attention": flash(f32, 32),
        "flash_attention_bf16": flash(bf16, 64),
        "fused_mlp": mlp(f32, 128, 352),
        "fused_mlp_bf16": mlp(bf16, 128, 256),
        "fused_mlp_int8": mlp(bf16, 128, 256, int8=True),
        "fused_mlp_routed": mlp(f32, 128, 352, routed=True),
        "fused_mlp_routed_bf16": mlp(bf16, 128, 256, routed=True),
        "moe_gmm": gmm(f32, 128, 96),
        "moe_gmm_bf16": gmm(bf16, 128, 128),
        "moe_gmm_bf16_narrow": gmm(bf16, 128, 96),
        "decode_attention": decode(f32),
        "decode_attention_bf16": decode(bf16),
        "decode_attention_int8": decode(bf16, int8=True),
        "paged_decode_attention": decode(f32, paged=True),
        "paged_decode_attention_bf16": decode(bf16, paged=True),
        "paged_decode_attention_int8": decode(bf16, paged=True, int8=True),
    }
