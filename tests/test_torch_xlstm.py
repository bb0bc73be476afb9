"""The port's xLSTM mixers (``repro_torch.models.xlstm``) and the xlstm
architecture held against the JAX package on the CPU.

The JAX ``init_lm`` weights are carried across (``load_jax_params``) and
the same numpy inputs, made from a seed, go through both.

Tolerances, as ``tests/test_torch_models.py``'s:
- float32 (params and compute cast to float32): atol = rtol = 1e-4 on
  logits and hidden states (the same float32 math summed in another order,
  through 8 layers); the chunked mLSTM alone atol = rtol = 1e-5;
- bfloat16 compute (the smoke config's own dtype) is held a mixer at a
  time on the same input, every element within 2^-6 * (|want| +
  rms(want's row)): two bfloat16 roundings may differ between XLA's fused
  elementwise code and PyTorch's op-by-op rounding.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.models import transformer as jt
from repro.models import xlstm as jx
from repro.models.config import ModelConfig as JModelConfig
from repro.models.config import Runtime as JRuntime
from repro.parallel.sharding import unbox
from repro.serving import Engine as JEngine
from repro_torch.configs import registry as treg
from repro_torch.launch import serve
from repro_torch.models import transformer as tt
from repro_torch.models import xlstm as tx
from repro_torch.models.config import ModelConfig, Runtime
from repro_torch.serving import Engine

F32 = dict(atol=1e-4, rtol=1e-4)
CHUNK = dict(atol=1e-5, rtol=1e-5)
BF16_ROW_TOL = 2.0 ** -6
KEY = jax.random.PRNGKey(0)
ARCH = "xlstm-350m"
RT_KW = dict(mlstm_chunk=8, remat=False)
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


def _mixer_cfg(kind: str, d: int = 32, heads: int = 4):
    kw = dict(name="x", family="ssm", n_layers=1, d_model=d, n_heads=heads, n_kv_heads=heads,
              d_ff=0, vocab_size=64, period=((kind, "none"),), param_dtype="float32",
              compute_dtype="float32")
    return JModelConfig(**kw), ModelConfig(**kw)


def _mixer(kind: str, d: int = 32, heads: int = 4):
    """A JAX mixer's params and the port's mixer with those weights."""
    jcfg, tcfg = _mixer_cfg(kind, d, heads)
    p = (jx.init_mlstm if kind == "mlstm" else jx.init_slstm)(KEY, jcfg)
    mod = (tx.MLSTM if kind == "mlstm" else tx.SLSTM)(tcfg)
    with torch.no_grad():
        for name, val in jax.tree_util.tree_map(_np, unbox(p)).items():
            getattr(mod, name).copy_(torch.from_numpy(val))
    return jcfg, p, mod


def _gates(b, s, nh, dh, seed):
    rng = np.random.RandomState(seed)
    q = (rng.standard_normal((b, s, nh, dh)) * 0.3).astype(np.float32)
    k = (rng.standard_normal((b, s, nh, dh)) * 0.3).astype(np.float32)
    v = (rng.standard_normal((b, s, nh, dh)) * 0.5).astype(np.float32)
    ig = (rng.standard_normal((b, s, nh)) * 0.5 - 1.0).astype(np.float32)
    fg = (rng.standard_normal((b, s, nh)) * 0.5 + 2.0).astype(np.float32)
    return q, k, v, ig, fg


# ==================================================================== mLSTM
@pytest.mark.parametrize("s,chunk", [(16, 4), (30, 7), (12, 64)])
def test_mlstm_chunked_matches_jax(s, chunk):
    """The chunked form's output and final (c, n) against the JAX
    package's, at chunks that divide S, that do not (fit_chunk) and that
    exceed it."""
    args = _gates(2, s, 2, 8, seed=s)
    h_j, (c_j, n_j) = jx._mlstm_chunked(*args, chunk=chunk)
    h_t, (c_t, n_t) = tx._mlstm_chunked(*map(torch.from_numpy, args), chunk)
    np.testing.assert_allclose(h_t.numpy(), _np(h_j), **CHUNK)
    np.testing.assert_allclose(c_t.numpy(), _np(c_j), **CHUNK)
    np.testing.assert_allclose(n_t.numpy(), _np(n_j), **CHUNK)


def test_mlstm_chunked_equals_the_step_by_step_decode():
    """The chunked prefill of a mixer (no stabilizer) against the exact
    stabilized recurrence run a token at a time from the empty cache over
    the same sequence: every output, and the states once the stabilizer is
    taken out (c e^m, n e^m; the prefill hands decode m = 0). The JAX
    package's decode step gives the same outputs."""
    jcfg, p, mix = _mixer("mlstm")
    x = np.random.RandomState(3).standard_normal((2, 12, 32)).astype(np.float32)
    with torch.no_grad():
        y_full, cache_full = mix(torch.from_numpy(x), Runtime(mlstm_chunk=4))
        cache = mix.init_cache(2, torch.float32, "cpu")
        jcache = jx.init_mlstm_cache(jcfg, 2)
        for t in range(12):
            y_t, cache = mix.decode(torch.from_numpy(x[:, t:t + 1]), cache)
            y_j, jcache = jx.mlstm_decode(p, jnp.asarray(x[:, t:t + 1]), jcache, jcfg)
            torch.testing.assert_close(y_t[:, 0], y_full[:, t], **F32)
            np.testing.assert_allclose(y_t.numpy(), _np(y_j), **F32)
    assert float(cache["m"].abs().min()) > 1.0   # the decode state is stabilized
    scale = torch.exp(cache["m"])
    torch.testing.assert_close(cache["c"] * scale[..., None, None], cache_full["c"],
                               atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(cache["n"] * scale[..., None], cache_full["n"],
                               atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(cache["conv"], cache_full["conv"])


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_mixer_train_and_decode_match_jax_f32(kind):
    """A mixer's prefill output and cache, then a decode step from that
    cache, against the JAX package's on the same weights."""
    jcfg, p, mix = _mixer(kind)
    x = np.random.RandomState(4).standard_normal((2, 10, 32)).astype(np.float32)
    train = jx.mlstm_train if kind == "mlstm" else jx.slstm_train
    decode = jx.mlstm_decode if kind == "mlstm" else jx.slstm_decode
    y_j, c_j = train(p, jnp.asarray(x[:, :9]), jcfg, JRuntime(mlstm_chunk=4))
    with torch.no_grad():
        y_t, c_t = mix(torch.from_numpy(x[:, :9]), Runtime(mlstm_chunk=4))
    np.testing.assert_allclose(y_t.numpy(), _np(y_j), **F32)
    assert c_t.keys() == c_j.keys()
    for name in c_t:
        np.testing.assert_allclose(c_t[name].numpy(), _np(c_j[name]), **F32, err_msg=name)
    d_j, n_j = decode(p, jnp.asarray(x[:, 9:]), c_j, jcfg)
    with torch.no_grad():
        d_t, n_t = mix.decode(torch.from_numpy(x[:, 9:]), c_t)
    np.testing.assert_allclose(d_t.numpy(), _np(d_j), **F32)
    for name in n_t:
        np.testing.assert_allclose(n_t[name].numpy(), _np(n_j[name]), **F32, err_msg=name)


def test_slstm_decode_matches_train():
    _, _, mix = _mixer("slstm", d=16, heads=2)
    x = torch.from_numpy(np.random.RandomState(5).standard_normal((2, 9, 16))
                         .astype(np.float32) * 0.5)
    with torch.no_grad():
        y_full, _ = mix(x, Runtime())
        _, cache = mix(x[:, :8], Runtime())
        y_dec, _ = mix.decode(x[:, 8:9], cache)
    torch.testing.assert_close(y_dec[:, 0], y_full[:, 8], atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("n_prompt", [1, 2])
def test_a_prompt_shorter_than_the_conv_history_decodes(n_prompt):
    """R8: a prompt of fewer than 3 tokens. The JAX package's mLSTM prefill
    caches fewer conv rows than its decode step reads, which then fails;
    the port caches the causal conv's zeros before the prompt, so its
    decode step equals the longer prefill's last output."""
    jcfg, p, mix = _mixer("mlstm")
    x = np.random.RandomState(6).standard_normal((1, n_prompt + 1, 32)).astype(np.float32)
    _, c_j = jx.mlstm_train(p, jnp.asarray(x[:, :n_prompt]), jcfg, JRuntime())
    assert c_j["conv"].shape[1] == n_prompt
    with pytest.raises(Exception):
        jx.mlstm_decode(p, jnp.asarray(x[:, n_prompt:]), c_j, jcfg)
    with torch.no_grad():
        y_full, _ = mix(torch.from_numpy(x), Runtime())
        _, cache = mix(torch.from_numpy(x[:, :n_prompt]), Runtime())
        y_dec, _ = mix.decode(torch.from_numpy(x[:, n_prompt:]), cache)
    assert cache["conv"].shape == (1, 3, 64)
    torch.testing.assert_close(y_dec[:, 0], y_full[:, n_prompt], **F32)


# ============================================================== the model
def test_forward_prefill_decode_match_jax_f32():
    """xlstm-smoke (7 mLSTM + 1 sLSTM): forward hidden states, the ragged
    prefill's logits and caches, and the decode step after it, against the
    JAX package in float32."""
    jcfg, params, model = _models(f32=True)
    jrt, rt = JRuntime(**RT_KW), Runtime(**RT_KW)
    toks = np.random.RandomState(1).randint(0, jcfg.vocab_size, (B, S)).astype(np.int32)
    tt_toks = torch.from_numpy(toks).long()
    last = np.array([S - 2, 19], np.int32)
    h_j, _, c_j = jax.jit(lambda p, t: jt.forward(p, jcfg, jrt, tokens=t, want_cache=True))(
        params, toks[:, :-1])
    lg_j = jt.common.top1_logits(h_j[np.arange(B), last], jt._out_embed(params, jcfg))
    with torch.no_grad():
        h_t, _, _ = tt.forward(model, rt, tokens=tt_toks[:, :-1])
    np.testing.assert_allclose(h_t.numpy(), _np(h_j), **F32)
    lg_t, c_t = tt.prefill(model, rt, tokens=tt_toks[:, :-1],
                           last_positions=torch.from_numpy(last))
    np.testing.assert_allclose(lg_t.numpy(), _np(lg_j), **F32)
    for p, pc in enumerate(c_t):
        for layer, cache in pc.items():
            assert cache.keys() == c_j[layer].keys()
            for name, a in cache.items():
                np.testing.assert_allclose(a.numpy(), _np(c_j[layer][name][p]), **F32,
                                           err_msg=f"{p}.{layer}.{name}")
    c_j, c_t = jt.pad_cache(c_j, jcfg, S + 4), tt.pad_cache(c_t, model.cfg, S + 4)
    d_j, _ = jax.jit(lambda p, c, t: jt.decode_step(p, c, t, S - 1, jcfg, jrt))(
        params, c_j, toks[:, -1:])
    d_t, _ = tt.decode_step(model, c_t, tt_toks[:, -1:], S - 1, rt)
    np.testing.assert_allclose(d_t.numpy(), _np(d_j), **F32)


def test_mixers_match_jax_bf16_on_the_same_inputs():
    """Each mixer of the smoke config's period in its own dtype (float32
    params, bfloat16 compute), fed the same bfloat16 input, row-scaled
    within 2^-6; the decode step after each likewise."""
    jcfg, params, model = _models(f32=False)
    jrt, rt = JRuntime(**RT_KW), Runtime(**RT_KW)
    x = jnp.asarray(np.random.RandomState(2).standard_normal((B, S, jcfg.d_model))
                    .astype(np.float32), jnp.bfloat16)
    pp = jax.tree_util.tree_map(lambda a: a[0], params["periods"])
    fns = {"mlstm": (jax.jit(lambda p, x: jx.mlstm_train(p, x, jcfg, jrt)),
                     jax.jit(lambda p, x, c: jx.mlstm_decode(p, x, c, jcfg))),
           "slstm": (jax.jit(lambda p, x: jx.slstm_train(p, x, jcfg, jrt)),
                     jax.jit(lambda p, x, c: jx.slstm_decode(p, x, c, jcfg)))}
    ratios = []
    for i, (mixer, _) in enumerate(jcfg.period):
        train, decode = fns[mixer]
        block = model.periods[0][f"l{i}"]
        y_j, c_j = train(pp[f"l{i}"]["mixer"], x[:, :-1])
        d_j, _ = decode(pp[f"l{i}"]["mixer"], x[:, -1:], c_j)
        with torch.no_grad():
            y_t, _ = block.mixer(_t(x[:, :-1], torch.bfloat16), rt)
            c_t = {n: _t(a) for n, a in c_j.items()}     # the decode step on JAX's cache
            d_t, _ = block.mixer.decode(_t(x[:, -1:], torch.bfloat16), c_t)
        assert y_t.dtype == d_t.dtype == torch.bfloat16
        ratios += [_row_scaled(y_t, _np(y_j), BF16_ROW_TOL),
                   _row_scaled(d_t, _np(d_j), BF16_ROW_TOL)]
        assert max(ratios[-2:]) <= 1.0, (i, mixer, ratios[-2:])
    assert max(ratios) > 0.0


def test_param_count_is_the_formula_and_the_mlstm_group_norm():
    """The JAX package's ``param_count`` leaves out each mLSTM's group-norm
    weight ``gn`` (Di values; its own test allows 6 %): the port's model
    holds exactly the JAX tree's parameters, that many more."""
    for cfg in (treg.get(ARCH).smoke, treg.get(ARCH).config):
        n_mlstm = sum(m == "mlstm" for m, _ in cfg.layer_list())
        n = tt.n_params(tt.LM(cfg, device="meta"))
        assert n == cfg.param_count()[0] + n_mlstm * cfg.ssm_expand * cfg.d_model
    tree = _jax_params()[1]
    leaves = jax.tree_util.tree_leaves(tree)
    assert sum(a.size for a in leaves) == tt.n_params(_models(f32=True)[2])


def test_full_config_is_bf16_and_about_0_4_billion_parameters():
    cfg = treg.get(ARCH).config
    model = tt.LM(cfg, device="meta")
    assert round(tt.n_params(model) / 1e9, 2) == 0.47
    assert {p.dtype for p in model.parameters()} == {torch.float32}
    assert [type(b.mixer).__name__ for b in model.periods[0].values()] == ["MLSTM"] * 7 + ["SLSTM"]


# ================================================================== serving
def test_greedy_tokens_equal_the_jax_engines_f32():
    jcfg = _f32(jreg.get(ARCH).smoke)
    params = _jax_params()[0]
    model = _models(f32=True)[2]
    rt_kw = dict(remat=False, moe_groups=1, mlstm_chunk=16)
    rng = np.random.RandomState(0)
    prompts = [rng.randint(1, jcfg.vocab_size, size=rng.randint(4, 16)).tolist()
               for _ in range(4)]
    want = JEngine(params, jcfg, JRuntime(**rt_kw)).generate(prompts, max_new=8)
    got = Engine(model, Runtime(**rt_kw)).generate(prompts, max_new=8)
    np.testing.assert_array_equal(got.tokens, want.tokens)


def test_slot_pool_holds_the_recurrent_state_of_each_slot():
    """The slot pool copies each admitted prompt's xLSTM caches (no sequence
    axis) into its slot: a request's greedy tokens do not depend on the
    slot or on what the other slots hold, and equal the static batch's."""
    model = _models(f32=True)[2]
    eng = Engine(model, Runtime(remat=False, mlstm_chunk=16), max_len=32)
    prompts = [[5, 6, 7, 8, 9], [11, 12, 13]]
    alone = [eng.generate([p], max_new=4).tokens[0].tolist() for p in prompts]
    pool = eng.slots(3)
    firsts = [pool.admit(2, prompts[0], uid=0), pool.admit(0, prompts[1], uid=1)]
    got = [[firsts[0]], [firsts[1]]]
    for _ in range(3):
        out = pool.step()
        got[0].append(int(out[2]))
        got[1].append(int(out[0]))
    assert got == alone


def test_launcher_serves_xlstm_on_the_cpu(capsys):
    eng = serve.main(["--arch", ARCH, "--device", "cpu", "--requests", "2", "--max-new", "3"])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("serve: xlstm-smoke (8 layers, ")
    assert eng.cfg == treg.get(ARCH).smoke
