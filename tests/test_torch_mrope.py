"""The port's M-RoPE (``common.apply_mrope``), its dispatch in the attention
block and patch-embedding inputs, and the qwen2-vl architecture, held
against the JAX package on the CPU.

Tolerances, as ``tests/test_torch_models.py``'s: float32 atol = rtol =
1e-4 on logits and hidden states; the rotation alone atol 2e-5, rtol 1e-5
(as the rope test's); bfloat16 compute a block at a time on the same input,
row-scaled within 2^-6.
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
from repro.models import common as jcommon
from repro.models import transformer as jt
from repro.models.config import Runtime as JRuntime
from repro.parallel.sharding import unbox
from repro_torch.configs import registry as treg
from repro_torch.models import common as tcommon
from repro_torch.models import pathcheck
from repro_torch.models import transformer as tt
from repro_torch.models.config import Runtime

F32 = dict(atol=1e-4, rtol=1e-4)
BF16_ROW_TOL = 2.0 ** -6
KEY = jax.random.PRNGKey(0)
ARCH = "qwen2-vl-2b"
RT_KW = dict(remat=False)
B, S = 2, 33


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
    params = jax.jit(lambda k: jt.init_lm(k, cfg))(KEY)
    return params, jax.tree_util.tree_map(_np, unbox(params))


def _models(*, f32: bool):
    jcfg, tcfg = jreg.get(ARCH).smoke, treg.get(ARCH).smoke
    if f32:
        jcfg, tcfg = _f32(jcfg), _f32(tcfg)
    params, tree = _jax_params()
    model = tt.LM(tcfg, device="cpu")
    tt.load_jax_params(model, tree)
    return jcfg, params, model


def _grid_positions(b: int, rows: int, cols: int) -> np.ndarray:
    """M-RoPE positions [3, B, rows * cols] of a patch grid: t 0, h the row,
    w the column."""
    h, w = np.meshgrid(np.arange(rows), np.arange(cols), indexing="ij")
    pos = np.stack([np.zeros(rows * cols, int), h.ravel(), w.ravel()])
    return np.broadcast_to(pos[:, None], (3, b, rows * cols)).astype(np.int32)


# ================================================================ M-RoPE
@pytest.mark.parametrize("sections,theta", [((2, 3, 3), 1e4), ((16, 24, 24), 1e6),
                                            ((4, 6, 6), 5e5)])
def test_apply_mrope_matches_jax(sections, theta):
    rng = np.random.RandomState(sum(sections))
    d = 2 * sum(sections)
    x = rng.standard_normal((2, 9, 3, d)).astype(np.float32)
    pos = rng.randint(0, 5000, (3, 2, 9)).astype(np.int32)
    want = jcommon.apply_mrope(x, pos, sections, theta)
    got = tcommon.apply_mrope(torch.from_numpy(x), torch.from_numpy(pos), sections, theta)
    np.testing.assert_allclose(got.numpy(), _np(want), atol=2e-5, rtol=1e-5)
    xb = jnp.asarray(x, jnp.bfloat16)
    got = tcommon.apply_mrope(_t(xb, torch.bfloat16), torch.from_numpy(pos), sections, theta)
    assert got.dtype == torch.bfloat16
    assert _row_scaled(got, _np(jcommon.apply_mrope(xb, pos, sections, theta)),
                       2.0 ** -8) <= 1.0


def test_mrope_equals_rope_when_streams_equal():
    rng = np.random.RandomState(8)
    x = torch.from_numpy(rng.standard_normal((2, 7, 2, 32)).astype(np.float32))
    pos = torch.from_numpy(rng.randint(0, 100, (2, 7)))
    got = tcommon.apply_mrope(x, pos[None].expand(3, 2, 7), (4, 6, 6), 1e4)
    torch.testing.assert_close(got, tcommon.apply_rope(x, pos, 1e4))
    with pytest.raises(ValueError, match="sum to D/2"):
        tcommon.apply_mrope(x, pos[None].expand(3, 2, 7), (4, 6, 5), 1e4)


def test_default_positions_under_mrope_raise_in_both():
    """R7: given no positions, ``forward`` builds [B,S] positions and the
    decode step [B,1], which the JAX package's ``apply_mrope`` indexes as
    if their batch axis were the three streams: an IndexError. The port
    raises a ValueError that names the [3,B,S] positions it needs, and
    runs with them."""
    jcfg, params, model = _models(f32=True)
    toks = np.ones((B, 5), np.int32)
    with pytest.raises(IndexError):
        jt.forward(params, jcfg, JRuntime(**RT_KW), tokens=toks)
    with pytest.raises(IndexError):
        jt.decode_step(params, jt.init_cache(jcfg, B, 8, jnp.float32), toks[:, :1], 0, jcfg,
                       JRuntime(**RT_KW))
    with torch.no_grad(), pytest.raises(ValueError, match=r"\[3, B, S\].*R7"):
        tt.forward(model, Runtime(**RT_KW), tokens=torch.from_numpy(toks))
    with pytest.raises(ValueError, match="R7"):
        tt.decode_step(model, tt.init_cache(model, B, 8, torch.float32),
                       torch.ones(B, 1, dtype=torch.long), 0, Runtime(**RT_KW))
    pos = torch.arange(5)[None, None].expand(3, B, 5)
    with torch.no_grad():
        h, _, _ = tt.forward(model, Runtime(**RT_KW), tokens=torch.from_numpy(toks),
                             positions=pos)
    assert h.shape == (B, 5, jcfg.d_model) and torch.isfinite(h).all()


# ============================================================== the model
@pytest.mark.parametrize("inputs", ["tokens", "embeds"])
def test_forward_prefill_decode_match_jax_f32(inputs):
    """qwen2-vl-smoke on token ids or on patch embeddings, M-RoPE positions
    of a patch grid (t 0, h the row, w the column): forward hidden states,
    prefill logits and caches, then a text token decoded at positions whose
    three streams all continue from the largest position plus one, against
    the JAX package in float32."""
    jcfg, params, model = _models(f32=True)
    jrt, rt = JRuntime(**RT_KW), Runtime(**RT_KW)
    rng = np.random.RandomState(1)
    n = 4 * 8
    pos = _grid_positions(B, 4, 8)
    kw_j, kw_t = {"positions": pos}, {"positions": torch.from_numpy(pos).long()}
    if inputs == "tokens":
        toks = rng.randint(0, jcfg.vocab_size, (B, n)).astype(np.int32)
        kw_j["tokens"], kw_t["tokens"] = toks, torch.from_numpy(toks).long()
    else:
        emb = rng.standard_normal((B, n, jcfg.d_model)).astype(np.float32)
        kw_j["embeds"], kw_t["embeds"] = emb, torch.from_numpy(emb)
    h_j, _, c_j = jt.forward(params, jcfg, jrt, want_cache=True, **kw_j)
    with torch.no_grad():
        h_t, _, _ = tt.forward(model, rt, **kw_t)
    np.testing.assert_allclose(h_t.numpy(), _np(h_j), **F32)
    lg_j, c_j = jt.prefill(params, jcfg, jrt, **kw_j)
    lg_t, c_t = tt.prefill(model, rt, **kw_t)
    np.testing.assert_allclose(lg_t.numpy(), _np(lg_j), **F32)
    for name, a in c_t[0]["l0"].items():
        np.testing.assert_allclose(a.numpy(), _np(c_j["l0"][name][0]), **F32, err_msg=name)

    nxt = np.full((3, B, 1), pos.max() + 1, np.int32)
    tok = rng.randint(0, jcfg.vocab_size, (B, 1)).astype(np.int32)
    c_j, c_t = jt.pad_cache(c_j, jcfg, n + 4), tt.pad_cache(c_t, model.cfg, n + 4)
    d_j, _ = jt.decode_step(params, c_j, tok, n, jcfg, jrt, positions=nxt)
    d_t, _ = tt.decode_step(model, c_t, torch.from_numpy(tok).long(), n, rt,
                            positions=torch.from_numpy(nxt).long())
    np.testing.assert_allclose(d_t.numpy(), _np(d_j), **F32)


def test_embeds_of_the_tokens_are_the_tokens():
    """``forward(embeds=E[tokens])`` is ``forward(tokens=tokens)``."""
    _, _, model = _models(f32=True)
    toks = torch.from_numpy(np.random.RandomState(3).randint(0, 512, (B, 9)))
    pos = torch.arange(9)[None, None].expand(3, B, 9)
    with torch.no_grad():
        a, _, _ = tt.forward(model, Runtime(), tokens=toks, positions=pos)
        b, _, _ = tt.forward(model, Runtime(), embeds=model.embed[toks], positions=pos)
    assert torch.equal(a, b)


def test_prefill_then_decode_equals_the_longer_forward():
    """The last position's logits of a forward of S tokens against a
    prefill of S - 1 and one decode step (the JAX package's own serving
    equivalence), at M-RoPE positions whose streams differ."""
    _, _, model = _models(f32=True)
    rng = np.random.RandomState(4)
    toks = torch.from_numpy(rng.randint(0, 512, (B, S)))
    pos = torch.from_numpy(rng.randint(0, 40, (3, B, S)))
    rt = Runtime(**RT_KW)
    with torch.no_grad():
        h, _, _ = tt.forward(model, rt, tokens=toks, positions=pos)
    gold = tcommon.top1_logits(h[:, -1], model.out_embed())
    _, c = tt.prefill(model, rt, tokens=toks[:, :-1], positions=pos[:, :, :-1])
    got, _ = tt.decode_step(model, tt.pad_cache(c, model.cfg, S), toks[:, -1:], S - 1, rt,
                            positions=pos[:, :, -1:])
    torch.testing.assert_close(got, gold, atol=2e-4, rtol=2e-4)


def test_blocks_match_jax_bf16_on_the_same_inputs():
    """Each attention (M-RoPE, 6 query heads a KV head) and MLP of the
    smoke config in its own dtype, fed the same bfloat16 input, row-scaled
    within 2^-6, through both attention impls of the port."""
    jcfg, params, model = _models(f32=False)
    jrt = JRuntime(**RT_KW)
    x = jnp.asarray(np.random.RandomState(2).standard_normal((B, S, jcfg.d_model))
                    .astype(np.float32), jnp.bfloat16)
    pos = np.random.RandomState(5).randint(0, 60, (3, B, S)).astype(np.int32)
    attn = jax.jit(lambda p, x: jblocks.attn_train(p, x, jcfg, jrt, pos)[0])
    mlp = jax.jit(lambda p, x: jblocks.mlp_apply(p, x, jcfg, jrt))
    ratios = []
    for i in range(jcfg.n_layers):
        p = jax.tree_util.tree_map(lambda a: a[i], params["periods"])["l0"]
        block = model.periods[i]["l0"]
        y_j = attn(p["mixer"], x)
        z_j = mlp(p["ffn"], y_j)
        with torch.no_grad():
            for impl in ("plain", "pallas"):
                y_t = block.mixer(_t(x, torch.bfloat16), Runtime(attn_impl=impl),
                                  torch.from_numpy(pos).long())[0]
                ratios.append(_row_scaled(y_t, _np(y_j), BF16_ROW_TOL))
            z_t = block.ffn(_t(y_j, torch.bfloat16))
        ratios.append(_row_scaled(z_t, _np(z_j), BF16_ROW_TOL))
        assert max(ratios[-3:]) <= 1.0, (i, ratios[-3:])
    assert max(ratios) > 0.0


def test_param_count_equals_the_port_models():
    for cfg in (treg.get(ARCH).smoke, treg.get(ARCH).config):
        assert cfg.param_count()[0] == tt.n_params(tt.LM(cfg, device="meta"))
    assert round(tt.n_params(tt.LM(treg.get(ARCH).config, device="meta")) / 1e9, 2) == 1.54


# ============================================================ path check
def _pathcheck_model():
    cfg = treg.get(ARCH).smoke
    model = tt.init_lm(cfg, seed=0, device="cpu")
    kern = Runtime(attn_impl="pallas")
    plain = dataclasses.replace(kern, attn_impl="plain")
    rng = np.random.RandomState(19)
    emb = torch.from_numpy(rng.standard_normal((2, 32, cfg.d_model)).astype(np.float32))
    return model, kern, plain, emb.bfloat16(), torch.from_numpy(_grid_positions(2, 4, 8)).long()


def test_layer_by_layer_check_holds_the_kernel_path_on_patch_embeddings():
    """The layer check on M-RoPE positions and patch embeddings (K5's plain
    version on the CPU); a decode step at positions past the grid."""
    model, kern, plain, emb, pos = _pathcheck_model()
    rows, ck, cp = pathcheck.prefill_layers(model, kern, plain, embeds=emb, positions=pos)
    nxt = torch.full((3, 2, 1), int(pos.max()) + 1)
    tok = torch.tensor([[7], [9]])
    rows += pathcheck.decode_layers(model, ck, cp, tok, 32, kern, plain, positions=nxt)
    assert len(rows) == 2 * (model.cfg.n_layers + 1)
    assert max(r["worst"] for r in rows) <= 1.0, rows


def test_layer_by_layer_check_rejects_k5_without_its_causal_mask(monkeypatch):
    """Control: K5 given causal=False on the decoder's self-attention fails
    the layer check."""
    from repro_torch.kernels import ops

    model, kern, plain, emb, pos = _pathcheck_model()
    real = ops.flash_attention
    monkeypatch.setattr(ops, "flash_attention",
                        lambda q, k, v, causal=True, **kw: real(q, k, v, causal=False, **kw))
    rows, _, _ = pathcheck.prefill_layers(model, kern, plain, embeds=emb, positions=pos)
    assert max(r["out"] for r in rows) > 1.0
