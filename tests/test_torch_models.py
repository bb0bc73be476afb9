"""The port's model side (``repro_torch.models``, ``repro_torch.configs``,
``repro_torch.kernels.ref``) held against the JAX package on the CPU.

The JAX ``init_lm`` weights are carried across (``load_jax_params``) and
the same numpy inputs, made from a seed, go through both.

Tolerances:
- float32 compute (params and compute cast to float32): the JAX package's
  own for its models, atol = rtol = 1e-4 on logits and hidden states (the
  same float32 math summed in another order, through up to 8 layers); the
  attention functions and the scan atol = rtol = 1e-5 and 5e-5 as in
  ``tests/test_models_math.py`` and ``tests/test_torch_scan.py``.
- bfloat16 compute (the smoke configs' own dtype) is held layer by layer,
  each mixer and each FFN on the same input, every element within
  2^-6 * (|want| + rms(want's row)): two bfloat16 roundings (2^-8 each of
  the value) may differ between XLA's fused elementwise code and
  PyTorch's op-by-op rounding, and a product summed over the row adds its
  rms. End to end, bfloat16 is not held: a router input one bfloat16 ulp
  apart moves a token to another expert (jamba-smoke, seed 0: with the
  same input to a whole Mamba + MoE layer, the Mamba outputs differ by
  0.0156, one ulp at 2-4, and the layer's output then by 0.82), which is
  routing, not a port fault. With identical inputs routing is held equal.
"""
import dataclasses
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.kernels import ref as jref
from repro.models import blocks as jblocks
from repro.models import common as jcommon
from repro.models import ssm as jssm
from repro.models import transformer as jt
from repro.models.config import ModelConfig as JModelConfig
from repro.models.config import Runtime as JRuntime
from repro.parallel.sharding import unbox
from repro_torch.configs import registry as treg
from repro_torch.kernels import ref as tref
from repro_torch.models import blocks as tblocks
from repro_torch.models import common as tcommon
from repro_torch.models import encdec as te
from repro_torch.models import pathcheck
from repro_torch.models import ssm as tssm
from repro_torch.models import transformer as tt
from repro_torch.models.config import ModelConfig, Runtime

F32 = dict(atol=1e-4, rtol=1e-4)
ATTN = dict(atol=1e-5, rtol=1e-5)
SCAN = dict(atol=5e-5, rtol=5e-5)
BF16_ROW_TOL = 2.0 ** -6
KEY = jax.random.PRNGKey(0)
# the registry's decoder-only architectures on token ids with plain rope
# (attention and Mamba mixers, dense and MoE FFNs); xlstm, seamless and
# qwen2-vl have test files of their own
PORTED = ("llama4-maverick-400b-a17b", "llama4-scout-17b-a16e", "internlm2-20b",
          "granite-3-8b", "llama3-405b", "yi-9b", "jamba-v0.1-52b")
RT_KW = dict(moe_groups=2, mamba_chunk=8, remat=False)
B, S = 2, 33


def _f32(cfg):
    return dataclasses.replace(cfg, param_dtype="float32", compute_dtype="float32")


def _np(a) -> np.ndarray:
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _t(a, dtype=torch.float32) -> torch.Tensor:
    return torch.from_numpy(np.array(_np(a))).to(dtype)


@functools.cache
def _jax_params(arch: str):
    """The JAX ``init_lm`` params of ``arch``'s smoke config (float32 params
    in every smoke config, so its float32 and bfloat16-compute variants
    share them) and their numpy tree."""
    cfg = jreg.get(arch).smoke
    assert cfg.param_dtype == "float32"
    params = jax.jit(lambda k: jt.init_lm(k, cfg))(KEY)
    return params, jax.tree_util.tree_map(_np, unbox(params))


def _models(arch: str, *, f32: bool):
    """The JAX params of ``arch``'s smoke config and the port's model with
    those weights (compute cast to float32 when ``f32``)."""
    jcfg, tcfg = jreg.get(arch).smoke, treg.get(arch).smoke
    if f32:
        jcfg, tcfg = _f32(jcfg), _f32(tcfg)
    params, tree = _jax_params(arch)
    model = tt.LM(tcfg, device="cpu")
    tt.load_jax_params(model, tree)
    return jcfg, params, model


def _row_scaled(got: torch.Tensor, want: np.ndarray, tol: float) -> float:
    """The worst |got - want| / (tol * (|want| + rms(want's row)))."""
    g, w = got.float().numpy().astype(np.float64), np.asarray(want, np.float64)
    limit = tol * (np.abs(w) + np.sqrt((w ** 2).mean(axis=-1, keepdims=True)))
    return float((np.abs(g - w) / limit).max())


# ================================================================= registry
@pytest.mark.parametrize("arch", jreg.all_arch_ids())
def test_registry_matches_jax(arch):
    j, t = jreg.get(arch), treg.get(arch)
    assert dataclasses.asdict(t.config) == dataclasses.asdict(j.config)
    assert dataclasses.asdict(t.smoke) == dataclasses.asdict(j.smoke)
    assert t.skips == j.skips and t.applicable_shapes() == j.applicable_shapes()
    assert t.config.param_count() == j.config.param_count()


def test_registry_tables_match_jax():
    assert treg.all_arch_ids() == jreg.all_arch_ids()
    assert treg.SHAPES == jreg.SHAPES
    assert [f.name for f in dataclasses.fields(ModelConfig)] == \
        [f.name for f in dataclasses.fields(JModelConfig)]
    assert dataclasses.asdict(Runtime()) == dataclasses.asdict(JRuntime())
    cfg = treg.get("jamba-v0.1-52b").config
    assert cfg.pdtype == torch.bfloat16 and cfg.cdtype == torch.bfloat16


@pytest.mark.parametrize("arch", PORTED)
def test_param_count_equals_the_port_models(arch):
    cfg = treg.get(arch).smoke
    assert cfg.param_count()[0] == tt.n_params(tt.LM(cfg, device="meta"))


def test_jamba_full_width_one_period_is_13_30_billion_parameters():
    """The serve phase's model: Jamba-v0.1 at full width, cut to one period
    of 8 layers (1 attention, 7 Mamba, 4 MoE, 4 dense)."""
    full = treg.get("jamba-v0.1-52b").config
    cfg = dataclasses.replace(full, n_layers=len(full.period))
    model = tt.LM(cfg, device="meta")
    n = tt.n_params(model)
    assert n == cfg.param_count()[0]
    assert round(n / 1e9, 2) == 13.30
    assert {p.dtype for p in model.parameters()} == {torch.bfloat16}


@pytest.mark.parametrize("arch,item", [("xlstm-350m", "13b"),
                                       ("seamless-m4t-large-v2", "13c"),
                                       ("qwen2-vl-2b", "13d")])
def test_unported_families_raise(arch, item):
    """The three families that raised until ROADMAP items 13b-13d were
    ported now build and run a forward at their smoke configs (their parity
    is held in ``tests/test_torch_xlstm.py``, ``test_torch_encdec.py`` and
    ``test_torch_mrope.py``). What raises now: an encoder-decoder config
    given to the decoder-only LM, and M-RoPE without its [3,B,S] positions
    (R7); embeddings feed any decoder-only config."""
    cfg = treg.get(arch).smoke
    b, s = 2, 8
    toks = torch.from_numpy(np.random.RandomState(0).randint(0, cfg.vocab_size, (b, s)))
    rt = Runtime(mlstm_chunk=4)
    with torch.no_grad():
        if item == "13c":
            with pytest.raises(ValueError, match="encoder-decoder"):
                tt.LM(cfg, device="meta")
            model = te.init_encdec(cfg, seed=0, device="cpu")
            h, _ = te.decode_train(model, rt, te.encode(model, rt, torch.ones(b, 2, cfg.d_model)),
                                   toks)
        else:
            model = tt.init_lm(cfg, seed=0, device="cpu")
            pos = torch.arange(s)[None, None].expand(3, b, s) if item == "13d" else None
            if item == "13d":
                with pytest.raises(ValueError, match="R7"):
                    tt.forward(model, rt, tokens=toks)
            h, _, _ = tt.forward(model, rt, tokens=toks, positions=pos)
    assert h.shape == (b, s, cfg.d_model) and torch.isfinite(h.float()).all()
    gcfg = treg.get("granite-3-8b").smoke
    granite = tt.LM(gcfg, device="meta")
    h, _, _ = tt.forward(granite, Runtime(), embeds=torch.zeros(1, 2, gcfg.d_model, device="meta"))
    assert h.shape == (1, 2, gcfg.d_model)


def test_load_jax_params_refuses_a_mismatched_tree():
    jcfg, _, model = _models("granite-3-8b", f32=True)
    tree = dict(_jax_params("granite-3-8b")[1])
    tree["extra"] = np.zeros(3, np.float32)
    with pytest.raises(ValueError, match="extra"):
        tt.load_jax_params(model, tree)
    del tree["extra"], tree["final_norm"]
    with pytest.raises(ValueError, match="final_norm"):
        tt.load_jax_params(model, tree)
    tree["final_norm"] = np.zeros(7, np.float32)
    with pytest.raises(ValueError, match="shapes that differ"):
        tt.load_jax_params(model, tree)


def test_init_lm_is_seeded_and_in_the_param_dtype():
    cfg = treg.get("jamba-v0.1-52b").smoke
    bf = dataclasses.replace(cfg, param_dtype="bfloat16")
    a, b = tt.init_lm(bf, seed=3, device="cpu"), tt.init_lm(bf, seed=3, device="cpu")
    c = tt.init_lm(bf, seed=4, device="cpu")
    for (name, pa), pb, pc in zip(a.named_parameters(), b.parameters(), c.parameters()):
        assert pa.dtype == torch.bfloat16, name
        assert torch.equal(pa, pb), name
    assert not torch.equal(a.embed, c.embed)
    # the JAX package's init values: norms 1, dt_b -4.6, a_log log(1..N),
    # d_skip 1, conv_b 0, dense weights truncated at 2 scales
    mamba = a.periods[0]["l1"].mixer
    assert torch.equal(mamba.norm, torch.ones_like(mamba.norm))
    assert torch.equal(mamba.dt_b, torch.full_like(mamba.dt_b, -4.6))
    assert torch.equal(mamba.a_log[3], torch.log(torch.arange(1, cfg.ssm_state + 1.0)).bfloat16())
    assert float(a.embed.detach().float().abs().max()) <= 2 * cfg.d_model ** -0.5 * (1 + 2 ** -8)
    assert 0.8 < float(a.embed.detach().float().std()) * cfg.d_model ** 0.5 < 1.0  # truncation


# ================================================================ end to end
@pytest.mark.parametrize("arch", PORTED)
def test_forward_prefill_decode_match_jax_f32(arch):
    """Forward hidden states, ragged prefill logits and caches, and the
    decode step after it, against the JAX package in float32."""
    jcfg, params, model = _models(arch, f32=True)
    jrt, rt = JRuntime(**RT_KW), Runtime(**RT_KW)
    toks = np.random.RandomState(1).randint(0, jcfg.vocab_size, (B, S)).astype(np.int32)
    tt_toks = torch.from_numpy(toks).long()

    last = np.array([S - 2, 19], np.int32)   # ragged: row 1's prompt ends at 19
    # the JAX package's prefill is its forward with caches, then the logits
    # at each row's last position
    h_j, aux_j, c_j = jax.jit(lambda p, t: jt.forward(p, jcfg, jrt, tokens=t,
                                                      want_cache=True))(params, toks[:, :-1])
    lg_j = jcommon.top1_logits(h_j[np.arange(B), last], jt._out_embed(params, jcfg))
    with torch.no_grad():
        h_t, aux_t, _ = tt.forward(model, rt, tokens=tt_toks[:, :-1])
    np.testing.assert_allclose(h_t.numpy(), _np(h_j), **F32)
    np.testing.assert_allclose(float(aux_t), float(aux_j), **F32)
    lg_t, c_t = tt.prefill(model, rt, tokens=tt_toks[:, :-1],
                           last_positions=torch.from_numpy(last))
    np.testing.assert_allclose(lg_t.numpy(), _np(lg_j), **F32)
    for p, pc in enumerate(c_t):
        for layer, cache in pc.items():
            assert cache.keys() == c_j[layer].keys()
            for name, a in cache.items():
                np.testing.assert_allclose(a.float().numpy(), _np(c_j[layer][name][p]), **F32,
                                           err_msg=f"{p}.{layer}.{name}")

    c_j, c_t = jt.pad_cache(c_j, jcfg, S + 4), tt.pad_cache(c_t, model.cfg, S + 4)
    d_j, _ = jax.jit(lambda p, c, t: jt.decode_step(p, c, t, S - 1, jcfg, jrt))(
        params, c_j, toks[:, -1:])
    d_t, _ = tt.decode_step(model, c_t, tt_toks[:, -1:], S - 1, rt)
    np.testing.assert_allclose(d_t.numpy(), _np(d_j), **F32)


@pytest.mark.parametrize("arch", PORTED)
def test_mixers_and_ffns_match_jax_bf16_on_the_same_inputs(arch):
    """Each mixer and each FFN of the smoke config's period in its own dtype
    (float32 params, bfloat16 compute), fed the same bfloat16 input: the
    FFN takes the JAX mixer's output, so a router sees identical inputs."""
    jcfg, params, model = _models(arch, f32=False)
    jrt, rt = JRuntime(**RT_KW), Runtime(**RT_KW)
    rng = np.random.RandomState(2)
    x = jnp.asarray(rng.standard_normal((B, S, jcfg.d_model)).astype(np.float32),
                    jnp.bfloat16)
    pos = jnp.broadcast_to(jnp.arange(S)[None], (B, S))
    t_pos = torch.arange(S)[None].expand(B, S)
    pp = jax.tree_util.tree_map(lambda a: a[0], params["periods"])
    # one jitted function a kind of layer, reused by the layers of its kind
    attn = jax.jit(lambda p, x: jblocks.attn_train(p, x, jcfg, jrt, pos)[0])
    mamba = jax.jit(lambda p, x: jssm.mamba_train(p, x, jcfg, jrt)[0])
    mlp = jax.jit(lambda p, x: jblocks.mlp_apply(p, x, jcfg, jrt))
    moe = jax.jit(lambda p, x: jblocks.moe_apply(p, x, jcfg, jrt))
    ratios = []
    for i, (mixer, ffn) in enumerate(jcfg.period):
        p, block = pp[f"l{i}"], model.periods[0][f"l{i}"]
        with torch.no_grad():
            if mixer == "attn":
                y_j = attn(p["mixer"], x)
                y_t = block.mixer(_t(x, torch.bfloat16), rt, t_pos)[0]
            else:
                y_j = mamba(p["mixer"], x)
                y_t = block.mixer(_t(x, torch.bfloat16), rt)[0]
            ratios.append(_row_scaled(y_t, _np(y_j), BF16_ROW_TOL))
            if ffn == "dense":
                z_j = mlp(p["ffn"], y_j)
                z_t = block.ffn(_t(y_j, torch.bfloat16), rt)
            else:
                z_j, aux_j = moe(p["ffn"], y_j)
                z_t, aux_t = block.ffn(_t(y_j, torch.bfloat16), rt)
                np.testing.assert_allclose(float(aux_t), float(aux_j), rtol=1e-5)
            ratios.append(_row_scaled(z_t, _np(z_j), BF16_ROW_TOL))
        assert y_t.dtype == z_t.dtype == torch.bfloat16
        assert max(ratios[-2:]) <= 1.0, (i, mixer, ffn, ratios[-2:])
        x = z_j
    assert max(ratios) > 0.0  # the two do round differently: the limit is not idle


@pytest.mark.parametrize("arch", ["jamba-v0.1-52b", "granite-3-8b"])
def test_kernel_path_prefill_matches_jax_kernel_path(arch):
    """``attn_impl="pallas"`` and ``use_pallas``: the JAX package's Pallas
    kernels in interpret mode against the port's wrappers (their plain
    versions on the CPU), prefill logits in float32. The JAX package hands
    K7 log(expm1(softplus(dt))), the port the pre-softplus dt: the float32
    round trip is far inside 1e-4."""
    jcfg, params, model = _models(arch, f32=True)
    kw = dict(RT_KW, attn_impl="pallas", use_pallas=True)
    jrt, rt = JRuntime(**kw), Runtime(**kw)
    toks = np.random.RandomState(3).randint(0, jcfg.vocab_size, (B, 16)).astype(np.int32)
    lg_j, _ = jt.prefill(params, jcfg, jrt, tokens=toks)
    lg_t, _ = tt.prefill(model, rt, tokens=torch.from_numpy(toks).long())
    np.testing.assert_allclose(lg_t.numpy(), _np(lg_j), **F32)


def test_decode_after_a_kernel_prefill_carries_the_real_mamba_state():
    """R3: the JAX package's kernel path caches a zero Mamba state, so its
    first decode step after a kernel prefill is not the plain path's. The
    port's kernel path (``mamba_scan(..., return_state=True)``) caches the
    real state: its decode step equals the JAX plain path's."""
    jcfg, params, model = _models("jamba-v0.1-52b", f32=True)
    toks = np.random.RandomState(4).randint(0, jcfg.vocab_size, (B, 17)).astype(np.int32)
    plain, kern = JRuntime(**RT_KW), JRuntime(**RT_KW, use_pallas=True)

    def jax_decode(rt):
        _, c = jt.prefill(params, jcfg, rt, tokens=toks[:, :-1])
        c = jt.pad_cache(c, jcfg, 17)
        return jt.decode_step(params, c, toks[:, -1:], 16, jcfg, rt)[0], c

    gold, c_plain = jax_decode(plain)
    r3, c_r3 = jax_decode(kern)
    mamba_layers = [f"l{i}" for i, (m, _) in enumerate(jcfg.period) if m == "mamba"]
    assert all(not np.any(_np(c_r3[l]["h"])) for l in mamba_layers)   # R3: zeros
    r3_err = float(np.abs(_np(r3) - _np(gold)).max())
    assert r3_err > 100 * F32["atol"], r3_err   # the zero state shows in the logits

    rt = Runtime(**RT_KW, use_pallas=True)
    t_toks = torch.from_numpy(toks).long()
    _, c_t = tt.prefill(model, rt, tokens=t_toks[:, :-1])
    for l in mamba_layers:
        np.testing.assert_allclose(c_t[0][l]["h"].numpy(), _np(c_plain[l]["h"][0]), **F32)
    d_t, _ = tt.decode_step(model, tt.pad_cache(c_t, model.cfg, 17), t_toks[:, -1:], 16, rt)
    np.testing.assert_allclose(d_t.numpy(), _np(gold), **F32)


# ================================================================= attention
def _qkv(b, sq, sk, h, kh, d, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((b, sq, h, d), (b, sk, kh, d), (b, sk, kh, d))]


@pytest.mark.parametrize("sq,sk,block", [(64, 64, 16), (32, 96, 32), (128, 128, 128)])
def test_plain_and_blockwise_attention_match_jax(sq, sk, block):
    q, k, v = _qkv(2, sq, sk, 4, 2, 32)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    for causal in (True, False):
        want = jcommon.plain_attention(q, k, v, causal=causal, q_offset=sk - sq)
        got = tcommon.plain_attention(tq, tk, tv, causal=causal, q_offset=sk - sq)
        np.testing.assert_allclose(got.numpy(), _np(want), **ATTN)
        want = jcommon.blockwise_attention(q, k, v, causal=causal, q_offset=sk - sq,
                                           block_k=block)
        got = tcommon.blockwise_attention(tq, tk, tv, causal=causal, q_offset=sk - sq,
                                          block_k=block)
        np.testing.assert_allclose(got.numpy(), _np(want), **ATTN)


def test_decode_attention_matches_jax_scalar_and_per_row_lengths():
    q, k, v = _qkv(2, 1, 64, 4, 2, 32, seed=1)
    tq, tk, tv = torch.from_numpy(q[:, 0]), torch.from_numpy(k), torch.from_numpy(v)
    for kv_len in (64, 17, np.array([64, 5], np.int32)):
        want = jcommon.decode_attention(q[:, 0], k, v, kv_len=kv_len)
        got = tcommon.decode_attention(tq, tk, tv, kv_len=torch.as_tensor(kv_len))
        np.testing.assert_allclose(got.numpy(), _np(want), **ATTN)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_impls_agree_with_jax_pallas_in_interpret_mode(dtype):
    """``impl="pallas"``: the JAX package's Pallas kernel (interpret mode)
    against the port's K5 wrapper (its plain version on the CPU), on q, k, v
    that are not contiguous, as a projection and rope leave them; "plain"
    and "blockwise" beside it. float32 within 1e-5, bfloat16 within one
    rounding of the output (row-scaled 2^-7)."""
    q, k, v = _qkv(2, 48, 48, 4, 2, 16, seed=2)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    jq, jk, jv = (jnp.asarray(a, jd) for a in (q, k, v))
    # [B,H,S,D] storage seen as [B,S,H,D]: not contiguous
    tq, tk, tv = (torch.from_numpy(_np(a)).to(td).transpose(1, 2).contiguous().transpose(1, 2)
                  for a in (jq, jk, jv))
    assert not tq.is_contiguous()
    want = _np(jcommon.attention(jq, jk, jv, causal=True, impl="pallas"))
    for impl in ("pallas", "plain", "blockwise"):
        got = tcommon.attention(tq, tk, tv, causal=True, impl=impl, block_k=16)
        assert got.dtype == td
        if dtype == "float32":
            np.testing.assert_allclose(got.numpy(), want, **ATTN)
        else:
            assert _row_scaled(got, want, 2.0 ** -7) <= 1.0, impl


# ======================================================================= rope
def test_rope_matches_jax():
    rng = np.random.RandomState(5)
    x = rng.standard_normal((2, 9, 3, 16)).astype(np.float32)
    pos = rng.randint(0, 5000, (2, 9)).astype(np.int32)
    want = jcommon.apply_rope(x, pos, 5e5)
    got = tcommon.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 5e5)
    np.testing.assert_allclose(got.numpy(), _np(want), atol=2e-5, rtol=1e-5)
    # the model's RMSNorm: float32 within an ulp or two (rsqrt, the mean's
    # order), bfloat16 within one rounding
    w = rng.standard_normal(16).astype(np.float32)
    for dt, rtol in ((jnp.float32, 1e-6), (jnp.bfloat16, 2.0 ** -8)):
        xx = jnp.asarray(x, dt)
        got = tcommon.rmsnorm(_t(xx, getattr(torch, jnp.dtype(dt).name)), torch.from_numpy(w))
        np.testing.assert_allclose(got.float().numpy(), _np(jcommon.rmsnorm(xx, w)),
                                   rtol=rtol, atol=1e-6)


# ======================================================================== moe
def _moe_cfg(**kw):
    base = dict(name="m", family="moe", n_layers=2, d_model=32, n_heads=4, n_kv_heads=2,
                d_ff=64, vocab_size=64, period=(("attn", "moe"),), n_experts=4, top_k=2,
                param_dtype="float32", compute_dtype="float32")
    base.update(kw)
    return JModelConfig(**base), ModelConfig(**base)


def test_dispatch_indices_match_jax():
    idx = np.array([[0, 0, 0, 1, 1, 2, 3, 3]])
    slot = tblocks._dispatch_indices(torch.from_numpy(idx), n_experts=4, capacity=2)
    assert slot[0].tolist() == [0, 1, 8, 2, 3, 4, 6, 7]   # the third of e0 dropped
    rng = np.random.RandomState(6)
    for g, n, e, cap in ((1, 40, 4, 8), (3, 33, 8, 8), (2, 64, 16, 2)):
        idx = rng.randint(0, e, (g, n)).astype(np.int32)
        want = np.asarray(jblocks._dispatch_indices(jnp.asarray(idx), e, cap))
        got = tblocks._dispatch_indices(torch.from_numpy(idx).long(), e, cap)
        np.testing.assert_array_equal(got.numpy(), want)


def test_top_k_breaks_ties_as_lax_top_k():
    gates = np.array([[0.25, 0.25, 0.25, 0.25], [0.1, 0.4, 0.4, 0.1], [0.3, 0.1, 0.3, 0.3],
                      [0.0, 0.5, 0.0, 0.5]], np.float32)
    for k in (1, 2, 3):
        wv, wi = jax.lax.top_k(jnp.asarray(gates), k)
        gv, gi = tblocks.top_k(torch.from_numpy(gates), k)
        np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
        np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))


@pytest.mark.parametrize("groups,capacity_factor", [(1, 1.25), (2, 1.25), (1, 8.0)])
def test_moe_routing_slots_and_output_match_jax(groups, capacity_factor):
    """The routing itself (top_e, each top-k slot's dispatch) equal, then
    the output and the aux loss; a zero router (every gate tied) routes
    every token to experts 0 and 1, as ``lax.top_k`` does."""
    jcfg, tcfg = _moe_cfg(capacity_factor=capacity_factor, shared_expert=groups == 2)
    p = jblocks.init_moe(KEY, jcfg)
    moe = tblocks.MoE(tcfg)
    with torch.no_grad():
        for name, val in jax.tree_util.tree_map(_np, unbox(p)).items():
            if name == "shared":
                for n2, v2 in val.items():
                    getattr(moe.shared, n2).copy_(torch.from_numpy(v2))
            else:
                getattr(moe, name).copy_(torch.from_numpy(val))
    x = np.random.RandomState(7).standard_normal((2, 12, 32)).astype(np.float32)
    jrt, rt = JRuntime(moe_groups=groups), Runtime(moe_groups=groups)

    h = jcommon.rmsnorm(jnp.asarray(x), p["norm"].value).reshape(groups, -1, 32)
    gates = jax.nn.softmax(jnp.einsum("gnd,de->gne", h, p["router"].value), -1)
    _, top_e = jax.lax.top_k(gates, 2)
    th = tcommon.rmsnorm(torch.from_numpy(x), moe.norm).reshape(groups, -1, 32)
    with torch.no_grad():
        _, _, t_top_e = moe._route(th, 2)
    np.testing.assert_array_equal(t_top_e.numpy(), np.asarray(top_e))
    ng = 24 // groups
    cap = max(int(capacity_factor * ng / 4) // 8 * 8, 8)
    for k in range(2):
        np.testing.assert_array_equal(
            tblocks._dispatch_indices(t_top_e[..., k], 4, cap).numpy(),
            np.asarray(jblocks._dispatch_indices(top_e[..., k], 4, cap)))

    y_j, aux_j = jblocks.moe_apply(p, jnp.asarray(x), jcfg, jrt)
    with torch.no_grad():
        y_t, aux_t = moe(torch.from_numpy(x), rt)
    np.testing.assert_allclose(y_t.numpy(), _np(y_j), **F32)
    np.testing.assert_allclose(float(aux_t), float(aux_j), **F32)

    with torch.no_grad():
        moe.router.zero_()
        _, _, tied = moe._route(th, 2)
    assert (tied[..., 0] == 0).all() and (tied[..., 1] == 1).all()


def test_pinned_routing_records_and_replays_the_expert_choices():
    """A replay takes the recorded choices whatever the router says, and
    counts the tokens whose own choice differed; the MoE's router is its
    own again after the block."""
    cfg = treg.get("jamba-v0.1-52b").smoke
    model = tt.init_lm(_f32(cfg), seed=0, device="cpu")
    toks = torch.from_numpy(np.random.RandomState(18).randint(0, cfg.vocab_size, (2, 9)))
    rt = Runtime(mamba_chunk=4)
    route = tblocks.MoE._route
    log = pathcheck.RoutingLog()
    with pathcheck.pinned_routing(log):
        want, _ = tt.prefill(model, rt, tokens=toks)
    assert len(log.choices) == 4 and log.choices[0].shape == (1, 18, 2)   # 4 MoE layers
    assert tblocks.MoE._route is route
    again = log.replayed()
    with pathcheck.pinned_routing(again):
        got, _ = tt.prefill(model, rt, tokens=toks)
    assert torch.equal(got, want) and again.moved == 0 and again.tokens == 72
    assert not again.choices and len(log.choices) == 4 and tblocks.MoE._route is route
    flipped = pathcheck.RoutingLog(choices=[c.flip(-1) for c in log.choices], replay=True)
    with pathcheck.pinned_routing(flipped):
        other, _ = tt.prefill(model, rt, tokens=toks)
    assert flipped.moved == 72 and torch.allclose(other, want, atol=1e-5)  # same pair of experts
    swapped = pathcheck.RoutingLog(choices=[(c + 1) % 4 for c in log.choices], replay=True)
    with pathcheck.pinned_routing(swapped):
        other, _ = tt.prefill(model, rt, tokens=toks)
    assert not torch.allclose(other, want, atol=1e-3)


def test_row_scaled_ratio_counts_errors_in_the_rows_scale():
    want = torch.tensor([[3.0, -4.0], [0.0, 0.0]])     # rms of row 0: 3.5355
    got = want + torch.tensor([[0.0, 0.25], [0.0, 0.0]])
    limit = 2.0 ** -4 * (4.0 + (12.5 ** 0.5))
    assert pathcheck.row_scaled_ratio(got, want, 2.0 ** -4) == pytest.approx(0.25 / limit)
    assert pathcheck.row_scaled_ratio(want, want, 2.0 ** -4) == 0.0
    off = want.clone()
    off[1, 0] = 1e-30                                  # an all-zero row must match exactly
    assert pathcheck.row_scaled_ratio(off, want, 2.0 ** -4) == float("inf")
    nan = want.clone()
    nan[0, 0] = float("nan")
    assert pathcheck.row_scaled_ratio(nan, want, 2.0 ** -4) == float("inf")
    with pytest.raises(ValueError, match="shapes differ"):
        pathcheck.row_scaled_ratio(want[0], want, 1.0)


def _pathcheck_model(arch: str):
    cfg = treg.get(arch).smoke
    model = tt.init_lm(cfg, seed=0, device="cpu")
    kern = Runtime(mamba_chunk=8, attn_impl="pallas", use_pallas=True)
    plain = dataclasses.replace(kern, attn_impl="plain", use_pallas=False)
    toks = torch.from_numpy(np.random.RandomState(19).randint(1, cfg.vocab_size, (2, 33)))
    return model, kern, plain, toks


@pytest.mark.parametrize("arch", ["jamba-v0.1-52b", "granite-3-8b"])
def test_layer_by_layer_check_holds_the_kernel_path(arch):
    """On the CPU the kernel path runs K5's and K7's plain versions: each
    layer of a bf16 smoke prefill, its caches, the logits and the first
    decode step stay within the check's limits (LAYER_TOL, STATE_TOL)."""
    model, kern, plain, toks = _pathcheck_model(arch)
    rows, ck, cp = pathcheck.prefill_layers(model, kern, plain, toks[:, :32])
    rows += pathcheck.decode_layers(model, ck, cp, toks[:, 32:], 32, kern, plain)
    n = len(model.cfg.layer_list())
    assert [r["step"] for r in rows] == ["prefill"] * (n + 1) + ["decode"] * (n + 1)
    assert max(r["worst"] for r in rows) <= 1.0, rows
    mamba = [r for r in rows if r["kind"] and r["kind"][0] == "mamba"]
    assert all(r["state"] is not None for r in mamba if r["step"] == "prefill")
    assert bool(mamba) == (arch == "jamba-v0.1-52b")


def test_layer_by_layer_check_rejects_a_k7_fault_and_the_zero_state(monkeypatch):
    """Controls: a K7 that drops its D skip fails the prefill layers, a
    state one step short fails them at the state, and the decode step from
    zero Mamba states (R3) fails the decode layers."""
    from repro_torch.kernels import ops

    model, kern, plain, toks = _pathcheck_model("jamba-v0.1-52b")
    real = ops.mamba_scan
    with monkeypatch.context() as m:
        m.setattr(ops, "mamba_scan", lambda x, dt, A, B, C, D, **kw: real(
            x, dt, A, B, C, torch.zeros_like(D), **kw))
        rows, _, _ = pathcheck.prefill_layers(model, kern, plain, toks[:, :32])
    assert max(r["out"] for r in rows if r["kind"] and r["kind"][0] == "mamba") > 1.0

    def short(x, dt, A, B, C, D, **kw):
        y, _ = real(x, dt, A, B, C, D, **kw)
        cut = [t[:, :-1].contiguous() for t in (x, dt, B, C)]
        return y, real(cut[0], cut[1], A, cut[2], cut[3], D, **kw)[1]

    with monkeypatch.context() as m:
        m.setattr(ops, "mamba_scan", short)
        rows, _, _ = pathcheck.prefill_layers(model, kern, plain, toks[:, :32])
    assert max(r["state"] or 0.0 for r in rows) > 1.0
    rows, ck, cp = pathcheck.prefill_layers(model, kern, plain, toks[:, :32])
    assert max(r["worst"] for r in rows) <= 1.0
    rows = pathcheck.decode_layers(model, pathcheck.zero_states(ck), cp, toks[:, 32:], 32,
                                   kern, plain)
    assert max(r["out"] for r in rows) > 1.0


def test_moe_gather_few_tokens_matches_jax():
    jcfg, tcfg = _moe_cfg(shared_expert=True, top_k=1)
    p = jblocks.init_moe(KEY, jcfg)
    moe = tblocks.MoE(tcfg)
    with torch.no_grad():
        for name, val in jax.tree_util.tree_map(_np, unbox(p)).items():
            if name == "shared":
                for n2, v2 in val.items():
                    getattr(moe.shared, n2).copy_(torch.from_numpy(v2))
            else:
                getattr(moe, name).copy_(torch.from_numpy(val))
    x = np.random.RandomState(8).standard_normal((3, 1, 32)).astype(np.float32)
    y_j, _ = jblocks.moe_apply(p, jnp.asarray(x), jcfg, JRuntime(moe_gather_decode=True))
    with torch.no_grad():
        y_t, aux = moe(torch.from_numpy(x), Runtime(moe_gather_decode=True))
    np.testing.assert_allclose(y_t.numpy(), _np(y_j), **F32)
    assert float(aux) == 0.0


# ======================================================================== ssm
def _scan_inputs(b=2, s=32, di=8, n=4, seed=9):
    rng = np.random.RandomState(seed)
    x = (rng.standard_normal((b, s, di)) * 0.5).astype(np.float32)
    dt_raw = (rng.standard_normal((b, s, di)) * 0.1).astype(np.float32)
    a = (-np.exp(rng.standard_normal((di, n)) * 0.3)).astype(np.float32)
    bb = (rng.standard_normal((b, s, n)) * 0.5).astype(np.float32)
    cc = (rng.standard_normal((b, s, n)) * 0.5).astype(np.float32)
    return x, dt_raw, a, bb, cc


@pytest.mark.parametrize("s,chunk", [(32, 8), (30, 7), (16, 64)])
def test_chunk_scan_matches_jax_and_the_reference_scan(s, chunk):
    x, dt_raw, a, bb, cc = _scan_inputs(s=s)
    dt = np.asarray(jax.nn.softplus(dt_raw))
    y_j, h_j = jssm._chunk_scan(dt, a, bb, cc, x, chunk=chunk)
    y_t, h_t = tssm._chunk_scan(*map(torch.from_numpy, (dt, a, bb, cc, x)), chunk)
    np.testing.assert_allclose(y_t.numpy(), _np(y_j), **SCAN)
    np.testing.assert_allclose(h_t.numpy(), _np(h_j), **SCAN)
    want, h_ref = tref.ref_selective_scan(*map(torch.from_numpy, (x, dt_raw, a, bb, cc)),
                                          torch.zeros(8))
    np.testing.assert_allclose(y_t.numpy(), want.numpy(), **SCAN)
    np.testing.assert_allclose(h_t.numpy(), h_ref.numpy(), **SCAN)


def test_associative_scan_is_the_recurrence():
    rng = np.random.RandomState(10)
    a = torch.from_numpy(rng.uniform(0.5, 1.0, (2, 13, 3)).astype(np.float32))
    u = torch.from_numpy(rng.standard_normal((2, 13, 3)).astype(np.float32))
    h, want = torch.zeros(2, 3), []
    for t in range(13):
        h = a[:, t] * h + u[:, t]
        want.append(h)
    torch.testing.assert_close(tssm._associative_scan(a, u), torch.stack(want, 1),
                               atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_mamba_train_decode_state_consistency(use_pallas):
    """The last token's decode step from the cache of the first 11 equals
    the 12-token prefill's last output, on both scan paths."""
    base = dict(name="m", family="hybrid", n_layers=1, d_model=16, n_heads=2, n_kv_heads=2,
                d_ff=32, vocab_size=64, period=(("mamba", "none"),), ssm_state=4,
                ssm_conv=4, ssm_expand=2, param_dtype="float32", compute_dtype="float32")
    cfg = ModelConfig(**base)
    mamba = tssm.Mamba(cfg)
    mamba.init_weights(torch.Generator().manual_seed(0))
    rt = Runtime(mamba_chunk=4, use_pallas=use_pallas)
    x = torch.from_numpy(np.random.RandomState(11).standard_normal((1, 12, 16))
                         .astype(np.float32) * 0.5)
    with torch.no_grad():
        y_full, _ = mamba(x, rt)
        _, cache = mamba(x[:, :11], rt)
        y_dec, _ = mamba.decode(x[:, 11:12], cache)
    torch.testing.assert_close(y_dec[:, 0], y_full[:, 11], **F32)


def test_a_prompt_shorter_than_the_conv_history_decodes():
    """R6: a prompt of fewer than ssm_conv - 1 tokens. The JAX package's
    prefill caches fewer conv rows than its decode step reads, which then
    fails; the port caches the causal conv's zeros before the prompt, so its
    decode step equals the longer prefill's last output."""
    jcfg = JModelConfig(name="m", family="hybrid", n_layers=1, d_model=16, n_heads=2,
                        n_kv_heads=2, d_ff=32, vocab_size=64, period=(("mamba", "none"),),
                        ssm_state=4, param_dtype="float32", compute_dtype="float32")
    p = jssm.init_mamba(KEY, jcfg)
    x = np.random.RandomState(17).standard_normal((1, 3, 16)).astype(np.float32)
    _, c_j = jssm.mamba_train(p, jnp.asarray(x[:, :2]), jcfg, JRuntime())
    assert c_j["conv"].shape[1] == 2
    with pytest.raises(Exception):
        jssm.mamba_decode(p, jnp.asarray(x[:, 2:]), c_j, jcfg)
    mamba = tssm.Mamba(ModelConfig(**dataclasses.asdict(jcfg)))
    mamba.init_weights(torch.Generator().manual_seed(0))
    with torch.no_grad():
        y_full, _ = mamba(torch.from_numpy(x), Runtime())
        _, cache = mamba(torch.from_numpy(x[:, :2]), Runtime())
        y_dec, _ = mamba.decode(torch.from_numpy(x[:, 2:]), cache)
    assert cache["conv"].shape == (1, 3, 32)
    torch.testing.assert_close(y_dec[:, 0], y_full[:, 2], **F32)


def test_mamba_block_matches_jax_on_both_paths():
    jcfg = JModelConfig(name="m", family="hybrid", n_layers=1, d_model=16, n_heads=2,
                        n_kv_heads=2, d_ff=32, vocab_size=64, period=(("mamba", "none"),),
                        ssm_state=8, param_dtype="float32", compute_dtype="float32")
    p = jssm.init_mamba(KEY, jcfg)
    mamba = tssm.Mamba(ModelConfig(**{f.name: getattr(jcfg, f.name)
                                      for f in dataclasses.fields(jcfg)}))
    with torch.no_grad():
        for name, val in jax.tree_util.tree_map(_np, unbox(p)).items():
            getattr(mamba, name).copy_(torch.from_numpy(val))
    x = np.random.RandomState(12).standard_normal((2, 20, 16)).astype(np.float32)
    y_j, c_j = jssm.mamba_train(p, jnp.asarray(x), jcfg, JRuntime(mamba_chunk=8))
    for use_pallas in (False, True):
        with torch.no_grad():
            y_t, c_t = mamba(torch.from_numpy(x), Runtime(mamba_chunk=8, use_pallas=use_pallas))
        np.testing.assert_allclose(y_t.numpy(), _np(y_j), **F32)
        np.testing.assert_allclose(c_t["h"].numpy(), _np(c_j["h"]), **F32)
        np.testing.assert_allclose(c_t["conv"].numpy(), _np(c_j["conv"]), **F32)
    xd = np.random.RandomState(13).standard_normal((2, 1, 16)).astype(np.float32)
    d_j, n_j = jssm.mamba_decode(p, jnp.asarray(xd), c_j, jcfg)
    with torch.no_grad():
        d_t, n_t = mamba.decode(torch.from_numpy(xd), c_t)
    np.testing.assert_allclose(d_t.numpy(), _np(d_j), **F32)
    np.testing.assert_allclose(n_t["h"].numpy(), _np(n_j["h"]), **F32)


# ================================================================= kernels.ref
def test_ref_oracles_match_jax_nan_rows_included():
    """All seven ``ref_*`` against the JAX package's on the same inputs. The
    causal rows that see no key (Sq 40 > Sk 24: the first 16) and the decode
    row of kv_len 0 stay NaN, as in the JAX package."""
    rng = np.random.RandomState(14)
    q, k, v = _qkv(2, 40, 24, 4, 2, 16, seed=15)
    for causal in (True, False):
        for cap in (None, 5.0):
            want = _np(jref.ref_attention(q, k, v, causal=causal, logit_soft_cap=cap))
            got = tref.ref_attention(*map(torch.from_numpy, (q, k, v)), causal=causal,
                                     logit_soft_cap=cap).numpy()
            np.testing.assert_allclose(got, want, **ATTN, equal_nan=True)
    got = tref.ref_attention(*map(torch.from_numpy, (q, k, v)), causal=True).numpy()
    assert np.isnan(got[:, :16]).all() and not np.isnan(got[:, 16:]).any()

    qd = q[:, 0]
    lens = np.array([24, 0], np.int32)
    want = _np(jref.ref_decode_attention(qd, k, v, lens))
    got = tref.ref_decode_attention(*map(torch.from_numpy, (qd, k, v)), torch.from_numpy(lens))
    np.testing.assert_allclose(got.numpy(), want, **ATTN, equal_nan=True)
    assert np.isnan(got[1].numpy()).all() and not np.isnan(got[0].numpy()).any()

    x = rng.standard_normal((3, 40)).astype(np.float32)
    w = rng.standard_normal(40).astype(np.float32)
    for dt, rtol in (("float32", 1e-6), ("bfloat16", 2.0 ** -8)):
        xx = jnp.asarray(x, getattr(jnp, dt))
        got = tref.ref_rmsnorm(_t(xx, getattr(torch, dt)), torch.from_numpy(w))
        np.testing.assert_allclose(got.float().numpy(), _np(jref.ref_rmsnorm(xx, w)),
                                   rtol=rtol, atol=1e-6)

    xs, dt_raw, a, bb, cc = _scan_inputs(s=20, seed=16)
    dd = rng.standard_normal(8).astype(np.float32)
    h0 = rng.standard_normal((2, 8, 4)).astype(np.float32)
    y_j, h_j = jref.ref_selective_scan(xs, dt_raw, a, bb, cc, dd, h0)
    y_t, h_t = tref.ref_selective_scan(*map(torch.from_numpy, (xs, dt_raw, a, bb, cc, dd, h0)))
    np.testing.assert_allclose(y_t.numpy(), _np(y_j), **SCAN)
    np.testing.assert_allclose(h_t.numpy(), _np(h_j), **SCAN)

    xa = rng.uniform(-1, 1, (8, 16)).astype(np.float32)
    aa = rng.uniform(0.5, 0.9, (8, 16)).astype(np.float32)
    np.testing.assert_allclose(
        tref.ref_alu_chain(torch.from_numpy(xa), torch.from_numpy(aa), 37).numpy(),
        _np(jref.ref_alu_chain(xa, aa, 37)), rtol=1e-6, atol=1e-6)

    ring = rng.permutation(64).astype(np.int32)
    assert tref.ref_chase(torch.from_numpy(ring), 3, 100) == jref.ref_chase(ring, 3, 100)
    assert tref.ref_chase(ring, 5, 7) == jref.ref_chase(ring, 5, 7)

    ma = rng.standard_normal((5, 7)).astype(np.float32)
    mb = rng.standard_normal((7, 3)).astype(np.float32)
    for dt in ("float32", "bfloat16"):
        ja, jb = jnp.asarray(ma, getattr(jnp, dt)), jnp.asarray(mb, getattr(jnp, dt))
        got = tref.ref_matmul(_t(ja, getattr(torch, dt)), _t(jb, getattr(torch, dt)))
        assert got.dtype == getattr(torch, dt)
        np.testing.assert_allclose(got.float().numpy(), _np(jref.ref_matmul(ja, jb)),
                                   rtol=1e-5 if dt == "float32" else 2 ** -8, atol=1e-5)
    assert math.isnan(float(tref.ref_decode_attention(
        torch.ones(1, 2, 4), torch.ones(1, 3, 1, 4), torch.ones(1, 3, 1, 4), 0)[0, 0, 0]))
