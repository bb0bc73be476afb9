"""The port's encoder-decoder (``repro_torch.models.encdec``, the attention
block's encoder memory and ``cross_decode``) and the seamless architecture,
held against the JAX package on the CPU.

The JAX ``init_encdec`` weights are carried across (``load_jax_params``)
and the same numpy inputs, made from a seed, go through both. Tolerances,
as ``tests/test_torch_models.py``'s: float32 atol = rtol = 1e-4 on logits
and hidden states (the JAX package's own consistency test allows 2e-4);
bfloat16 compute a block at a time on the same input, row-scaled within
2^-6.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.models import blocks as jblocks
from repro.models import encdec as je
from repro.models.config import Runtime as JRuntime
from repro.parallel.sharding import unbox
from repro_torch.configs import registry as treg
from repro_torch.launch import serve
from repro_torch.models import common as tcommon
from repro_torch.models import encdec as te
from repro_torch.models import pathcheck
from repro_torch.models import transformer as tt
from repro_torch.models.config import Runtime

F32 = dict(atol=1e-4, rtol=1e-4)
BF16_ROW_TOL = 2.0 ** -6
KEY = jax.random.PRNGKey(0)
ARCH = "seamless-m4t-large-v2"
B, S, SE = 2, 17, 8


def _f32(cfg):
    return dataclasses.replace(cfg, param_dtype="float32", compute_dtype="float32")


def _np(a) -> np.ndarray:
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _t(a, dtype=torch.float32) -> torch.Tensor:
    return torch.from_numpy(np.array(_np(a))).to(dtype)


def _row_scaled(got: torch.Tensor, want: np.ndarray, tol: float) -> float:
    g, w = got.float().numpy().astype(np.float64), np.asarray(want, np.float64)
    limit = tol * (np.abs(w) + np.sqrt((w ** 2).mean(axis=-1, keepdims=True)))
    return float((np.abs(g - w) / limit).max())


@functools.cache
def _jax_params():
    cfg = jreg.get(ARCH).smoke
    params = jax.jit(lambda k: je.init_encdec(k, cfg))(KEY)
    return params, jax.tree_util.tree_map(_np, unbox(params))


def _models(*, f32: bool):
    jcfg, tcfg = jreg.get(ARCH).smoke, treg.get(ARCH).smoke
    if f32:
        jcfg, tcfg = _f32(jcfg), _f32(tcfg)
    params, tree = _jax_params()
    model = te.EncDec(tcfg, device="cpu")
    tt.load_jax_params(model, tree)
    return jcfg, params, model


def _inputs(d: int, seed: int = 1):
    rng = np.random.RandomState(seed)
    frames = rng.standard_normal((B, SE, d)).astype(np.float32)
    toks = rng.randint(0, 512, (B, S)).astype(np.int32)
    return frames, toks


def _pad_jax(caches, n: int):
    return jax.tree_util.tree_map_with_path(
        lambda path, a: jnp.pad(a, [(0, 0), (0, 0), (0, n - a.shape[2]), (0, 0), (0, 0)])
        if path[-1].key in ("k", "v") else a, caches)


# ================================================================= the model
@pytest.mark.parametrize("attn_impl", ["plain", "pallas"])
def test_encode_prefill_decode_match_jax_f32(attn_impl):
    """The memory, the teacher-forced hidden states and caches, the prefill
    logits and a decode step with the cross cache, against the JAX package
    in float32; ``"pallas"`` holds K5's plain version (non-causal encoder,
    cross-attention of S queries to Se keys) against the JAX Pallas kernel
    in interpret mode."""
    jcfg, params, model = _models(f32=True)
    jrt, rt = JRuntime(remat=False, attn_impl=attn_impl), Runtime(attn_impl=attn_impl)
    frames, toks = _inputs(jcfg.d_model)
    mem_j = je.encode(params, jcfg, jrt, frames)
    with torch.no_grad():
        mem_t = te.encode(model, rt, torch.from_numpy(frames))
    np.testing.assert_allclose(mem_t.numpy(), _np(mem_j), **F32)
    h_j, c_j = je.decode_train(params, jcfg, jrt, mem_j, toks)
    with torch.no_grad():
        h_t, c_t = te.decode_train(model, rt, mem_t, torch.from_numpy(toks))
    np.testing.assert_allclose(h_t.numpy(), _np(h_j), **F32)
    for i, c in enumerate(c_t):
        assert c.keys() == c_j.keys()
        for name, a in c.items():
            np.testing.assert_allclose(a.numpy(), _np(c_j[name][i]), **F32, err_msg=name)
    lg_j, c_j = je.prefill(params, jcfg, jrt, frames, toks[:, :-1])
    lg_t, c_t = te.prefill(model, rt, torch.from_numpy(frames), torch.from_numpy(toks[:, :-1]))
    np.testing.assert_allclose(lg_t.numpy(), _np(lg_j), **F32)
    d_j, _ = je.decode_step(params, _pad_jax(c_j, S + 2), toks[:, -1:], S - 1, jcfg, jrt)
    d_t, _ = te.decode_step(model, te.pad_cache(c_t, S + 2), torch.from_numpy(toks[:, -1:]),
                            S - 1, rt)
    np.testing.assert_allclose(d_t.numpy(), _np(d_j), **F32)


def test_prefill_then_decode_equals_teacher_forcing():
    """The JAX package's own check (``test_encdec_prefill_decode_consistency``)
    on the port: encode, the teacher-forced decoder's last logits against a
    prefill of S - 1 tokens and one decode step with the cross cache, and a
    second step on from the first against the teacher-forced S + 1."""
    jcfg, _, model = _models(f32=True)
    rt = Runtime(remat=False, xent_chunk=16, moe_groups=1)
    frames, toks = _inputs(jcfg.d_model, seed=2)
    fr, tk = torch.from_numpy(frames), torch.from_numpy(toks)
    with torch.no_grad():
        mem = te.encode(model, rt, fr)
        h, _ = te.decode_train(model, rt, mem, tk)
    gold = tcommon.top1_logits(h[:, -2:], model.embed)
    _, caches = te.prefill(model, rt, fr, tk[:, :-2])
    caches = te.pad_cache(caches, S)
    assert caches[0]["k"].shape[1] == S and caches[0]["ck"].shape[1] == SE
    lg1, caches = te.decode_step(model, caches, tk[:, -2:-1], S - 2, rt)
    lg2, _ = te.decode_step(model, caches, tk[:, -1:], S - 1, rt)
    torch.testing.assert_close(lg1, gold[:, 0], atol=2e-4, rtol=2e-4)
    torch.testing.assert_close(lg2, gold[:, 1], atol=2e-4, rtol=2e-4)


def test_blocks_match_jax_bf16_on_the_same_inputs():
    """Encoder attention (not causal), decoder self-attention, cross-attention
    to a memory of another length, its decode step (``attn_cross_decode``)
    and the MLP, each in the smoke config's own dtype on the same bfloat16
    input, row-scaled within 2^-6, through both attention impls."""
    jcfg, params, model = _models(f32=False)
    jrt = JRuntime(remat=False)
    rng = np.random.RandomState(3)
    x = jnp.asarray(rng.standard_normal((B, S, jcfg.d_model)).astype(np.float32), jnp.bfloat16)
    mem = jnp.asarray(rng.standard_normal((B, SE, jcfg.d_model)).astype(np.float32),
                      jnp.bfloat16)
    pos = jnp.broadcast_to(jnp.arange(S)[None], (B, S))
    enc = jax.tree_util.tree_map(lambda a: a[0], params["encoder"])
    dec = jax.tree_util.tree_map(lambda a: a[0], params["decoder"])
    want = {
        "enc": jblocks.attn_train(enc["attn"], x, jcfg, jrt, pos, causal=False)[0],
        "self": jblocks.attn_train(dec["self"], x, jcfg, jrt, pos)[0],
        "cross": jblocks.attn_train(dec["cross"], x, jcfg, jrt, None, kv=mem)[0],
        "mlp": jblocks.mlp_apply(dec["ffn"], x, jcfg),
    }
    _, (ck, cv) = jblocks.attn_train(dec["cross"], x, jcfg, jrt, None, kv=mem)
    want["cross_decode"] = jblocks.attn_cross_decode(dec["cross"], x[:, :1], (ck, cv), jcfg)
    tx, tm = _t(x, torch.bfloat16), _t(mem, torch.bfloat16)
    tpos = torch.arange(S)[None].expand(B, S)
    enc_t, dec_t = model.encoder[0], model.decoder[0]
    ratios = {}
    with torch.no_grad():
        for impl in ("plain", "pallas"):
            rt = Runtime(attn_impl=impl)
            got = {"enc": enc_t["attn"](tx, rt, tpos, causal=False)[0],
                   "self": dec_t["self"](tx, rt, tpos)[0],
                   "cross": dec_t["cross"](tx, rt, None, kv=tm)[0]}
            for name, y in got.items():
                assert y.dtype == torch.bfloat16
                ratios[(impl, name)] = _row_scaled(y, _np(want[name]), BF16_ROW_TOL)
        ratios["mlp"] = _row_scaled(dec_t["ffn"](tx), _np(want["mlp"]), BF16_ROW_TOL)
        got = dec_t["cross"].cross_decode(tx[:, :1], (_t(ck, torch.bfloat16),
                                                      _t(cv, torch.bfloat16)))
        ratios["cross_decode"] = _row_scaled(got, _np(want["cross_decode"]), BF16_ROW_TOL)
    assert max(ratios.values()) <= 1.0, ratios
    assert max(ratios.values()) > 0.0


def test_param_names_load_and_count():
    """The JAX ``init_encdec`` tree loads into the port's model name for name
    (the stacked encoder and decoder layers split), a tree with a name left
    over is refused, and the parameter count is ``param_count``'s, also at
    full width: 1.77 billion."""
    _, tree = _jax_params()
    model = te.EncDec(treg.get(ARCH).smoke, device="cpu")
    tt.load_jax_params(model, tree)
    assert sum(a.size for a in jax.tree_util.tree_leaves(tree)) == tt.n_params(model)
    bad = {**tree, "extra": np.zeros(2, np.float32)}
    with pytest.raises(ValueError, match="extra"):
        tt.load_jax_params(model, bad)
    for cfg in (treg.get(ARCH).smoke, treg.get(ARCH).config):
        assert tt.n_params(te.EncDec(cfg, device="meta")) == cfg.param_count()[0]
    full = te.EncDec(treg.get(ARCH).config, device="meta")
    assert round(tt.n_params(full) / 1e9, 2) == 1.77
    with pytest.raises(ValueError, match="encoder-decoder"):
        tt.LM(treg.get(ARCH).smoke, device="meta")


def test_init_encdec_is_seeded():
    cfg = dataclasses.replace(treg.get(ARCH).smoke, param_dtype="bfloat16")
    a, b = te.init_encdec(cfg, seed=3, device="cpu"), te.init_encdec(cfg, seed=3, device="cpu")
    for (name, pa), pb in zip(a.named_parameters(), b.parameters()):
        assert pa.dtype == torch.bfloat16 and torch.equal(pa, pb), name
    assert torch.equal(a.enc_norm, torch.ones_like(a.enc_norm))
    assert not torch.equal(a.encoder[0]["attn"].wq, a.decoder[0]["cross"].wq)


# ================================================================ path check
def _pathcheck_model():
    cfg = treg.get(ARCH).smoke
    model = te.init_encdec(cfg, seed=0, device="cpu")
    kern, plain = Runtime(attn_impl="pallas"), Runtime(attn_impl="plain")
    rng = np.random.RandomState(19)
    frames = torch.from_numpy(rng.standard_normal((2, 8, cfg.d_model)).astype(np.float32))
    toks = torch.from_numpy(rng.randint(1, cfg.vocab_size, (2, 33)))
    return model, kern, plain, frames.bfloat16(), toks


def test_layer_by_layer_check_holds_the_kernel_path():
    model, kern, plain, frames, toks = _pathcheck_model()
    rows, ck, cp = pathcheck.encdec_prefill_layers(model, kern, plain, frames, toks[:, :32])
    rows += pathcheck.encdec_decode_layers(model, ck, cp, toks[:, 32:], 32, kern, plain)
    n_enc, n_dec = model.cfg.n_encoder_layers, model.cfg.n_layers
    assert [r["step"] for r in rows] == (["encode"] * (n_enc + 1) + ["prefill"] * (n_dec + 1)
                                         + ["decode"] * (n_dec + 1))
    assert max(r["worst"] for r in rows) <= 1.0, rows


def test_layer_by_layer_check_rejects_k5_made_causal_on_the_encoder(monkeypatch):
    """Control: K5 given the causal flag on the encoder's self-attention
    (queries and keys of one length, not causal) fails the check."""
    from repro_torch.kernels import ops

    model, kern, plain, frames, toks = _pathcheck_model()
    real = ops.flash_attention

    def causal_encoder(q, k, v, causal=True, **kw):
        return real(q, k, v, causal=causal or q.shape[1] == k.shape[1], **kw)

    monkeypatch.setattr(ops, "flash_attention", causal_encoder)
    rows, _, _ = pathcheck.encdec_prefill_layers(model, kern, plain, frames, toks[:, :32])
    assert max(r["out"] for r in rows if r["step"] == "encode") > 1.0


def test_launcher_refuses_the_frame_and_patch_embedding_archs():
    """seamless takes frame embeddings and qwen2-vl patch embeddings with
    M-RoPE positions: the JAX package serves neither through its launcher
    (its ``init_lm`` of the seamless config drops the encoder, and its
    prefill of qwen2-vl fails, R7). The port's launcher says how to drive
    them instead."""
    for arch in (ARCH, "qwen2-vl-2b"):
        with pytest.raises(ValueError, match="prefill"):
            serve.main(["--arch", arch, "--device", "cpu"])
