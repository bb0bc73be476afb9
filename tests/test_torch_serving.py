"""The port's serving side (``repro_torch.serving``, ``repro_torch.launch.serve``)
on the CPU: greedy tokens against the JAX package's ``Engine``, the static
batch's semantics (ragged prompts, eos waste slots, the early stop, seeded
sampling), the slot pool, the launcher, and the import guard of the whole
package.

Tolerance: greedy tokens are compared exactly. In float32 the two models'
logits agree to about 1e-6 (``tests/test_torch_models.py``), so an argmax
differs only where two logits tie that closely; none do on these inputs.
"""
import ast
import contextlib
import dataclasses
import io
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.models import transformer as jt
from repro.models.config import Runtime as JRuntime
from repro.parallel.sharding import unbox
from repro.serving import Engine as JEngine
from repro_torch.configs import registry as treg
from repro_torch.launch import serve
from repro_torch.models import transformer as tt
from repro_torch.models.config import ModelConfig, Runtime
from repro_torch.serving import Engine, SlotPool

ROOT = Path(__file__).resolve().parents[1]
# the JAX package's serving_tiny_config (repro/api/probes.py)
CFG = ModelConfig(name="serving-tiny", family="dense", n_layers=2, d_model=32, n_heads=4,
                  n_kv_heads=2, d_ff=64, vocab_size=128, param_dtype="float32",
                  compute_dtype="float32")
RT = Runtime(remat=False, xent_chunk=16, moe_groups=1)


@pytest.fixture(scope="module")
def engine():
    return Engine(tt.init_lm(CFG, seed=0, device="cpu"), RT)


# ==================================================== against the JAX Engine
@pytest.mark.parametrize("arch", ["jamba-v0.1-52b", "granite-3-8b"])
def test_greedy_tokens_equal_the_jax_engines_f32(arch):
    over = dict(param_dtype="float32", compute_dtype="float32")
    jcfg = dataclasses.replace(jreg.get(arch).smoke, **over)
    tcfg = dataclasses.replace(treg.get(arch).smoke, **over)
    rt_kw = dict(remat=False, moe_groups=1, mamba_chunk=16)
    params = jax.jit(lambda k: jt.init_lm(k, jcfg))(jax.random.PRNGKey(0))
    model = tt.LM(tcfg, device="cpu")
    tt.load_jax_params(model, jax.tree_util.tree_map(np.asarray, unbox(params)))
    rng = np.random.RandomState(0)
    prompts = [rng.randint(1, jcfg.vocab_size, size=rng.randint(4, 16)).tolist()
               for _ in range(4)]
    want = JEngine(params, jcfg, JRuntime(**rt_kw)).generate(prompts, max_new=8)
    got = Engine(model, Runtime(**rt_kw)).generate(prompts, max_new=8)
    np.testing.assert_array_equal(got.tokens, want.tokens)
    np.testing.assert_array_equal(got.prompt_lens, want.prompt_lens)
    assert got.steps == want.steps == 8
    assert got.prefill_s > 0 and got.decode_s > 0


# ===================================================== static-batch semantics
def test_ragged_prompts_right_padded_first_token_exact(engine):
    """A short row in a ragged batch samples its first token from its own
    last prompt token: it matches the same prompt run alone."""
    long, short = [5, 6, 7, 8, 9, 10], [11, 12]
    batched = engine.generate([long, short], max_new=1)
    assert batched.tokens[1, 0] == engine.generate([short], max_new=1).tokens[0, 0]
    assert batched.tokens[0, 0] == engine.generate([long], max_new=1).tokens[0, 0]
    np.testing.assert_array_equal(batched.prompt_lens, [6, 2])


def test_waste_slot_masking(engine):
    """Once a row emits eos it keeps decoding (static batch), but everything
    after its eos is masked out of the result."""
    free = engine.generate([[1, 2, 3], [4, 5, 6]], max_new=6)
    eos = int(free.tokens[0, 1])        # a token row 0 actually emits
    r = engine.generate([[1, 2, 3], [4, 5, 6]], max_new=6, eos_id=eos)
    s0 = r.finished_steps[0]
    assert 0 <= s0 <= 1
    assert int(r.tokens[0, s0]) == eos
    assert (r.tokens[0, s0 + 1:] == eos).all()
    if r.finished_steps[1] < 0:
        np.testing.assert_array_equal(r.tokens[1, :r.steps], free.tokens[1, :r.steps])


def test_all_rows_finished_stops_early(engine):
    free = engine.generate([[1, 2, 3]], max_new=8)
    eos = int(free.tokens[0, 0])        # the first emitted token ends the row
    r = engine.generate([[1, 2, 3]], max_new=8, eos_id=eos)
    assert r.finished_steps[0] == 0
    assert r.steps < 8
    assert (r.tokens[0, 1:] == eos).all()


def test_no_eos_keeps_the_plain_result(engine):
    r = engine.generate([[1, 2, 3], [4, 5]], max_new=4)
    assert r.tokens.shape == (2, 4) and r.steps == 4 and r.finished_steps is None


def test_temperature_sampling_is_seeded_and_greedy_ignores_the_seed(engine):
    a = engine.generate([[1, 2, 3]], max_new=6, temperature=0.8, seed=7)
    b = engine.generate([[1, 2, 3]], max_new=6, temperature=0.8, seed=7)
    np.testing.assert_array_equal(a.tokens, b.tokens)
    others = [engine.generate([[1, 2, 3]], max_new=6, temperature=0.8, seed=s)
              for s in range(1, 5)]
    assert any((o.tokens != a.tokens).any() for o in others)
    g0 = engine.generate([[1, 2, 3]], max_new=4, temperature=0.0, seed=0)
    g1 = engine.generate([[1, 2, 3]], max_new=4, temperature=0.0, seed=123)
    np.testing.assert_array_equal(g0.tokens, g1.tokens)


# ================================================================= slot pool
@pytest.fixture(scope="module")
def pool_engine():
    return Engine(tt.init_lm(CFG, seed=0, device="cpu"), RT, max_len=32)


def test_slot_pool_matches_static_generate(pool_engine):
    """Two concurrently admitted slots each reproduce their prompt's solo
    static-generate output exactly."""
    pool = pool_engine.slots(2)
    assert isinstance(pool, SlotPool)
    p0, p1 = [5, 6, 7, 8], [11, 12]
    toks0, toks1 = [pool.admit(0, p0, max_new=4)], [pool.admit(1, p1, max_new=4)]
    for _ in range(3):
        out = pool.step()
        toks0.append(int(out[0]))
        toks1.append(int(out[1]))
    np.testing.assert_array_equal(toks0, pool_engine.generate([p0], max_new=4).tokens[0])
    np.testing.assert_array_equal(toks1, pool_engine.generate([p1], max_new=4).tokens[0])


def test_slot_pool_recycled_slot_matches_solo_run(pool_engine):
    """evict + admit mid-flight: the recycled slot decodes as if it ran alone
    while the other slot keeps its own stream."""
    pool = pool_engine.slots(2)
    pool.admit(0, [5, 6, 7], max_new=2)
    keep = [pool.admit(1, [9, 10, 11, 12], max_new=6)]
    keep.append(int(pool.step()[1]))
    pool.evict(0)
    assert pool.free_slots() == [0] and pool.active_slots() == [1]
    fresh = [pool.admit(0, [21, 22, 23], max_new=3)]
    for _ in range(2):
        out = pool.step()
        fresh.append(int(out[0]))
        keep.append(int(out[1]))
    np.testing.assert_array_equal(fresh, pool_engine.generate([[21, 22, 23]], max_new=3).tokens[0])
    np.testing.assert_array_equal(keep, pool_engine.generate([[9, 10, 11, 12]],
                                                             max_new=4).tokens[0])
    assert pool.position(1) == 4 + 3


def test_slot_pool_admit_validation(pool_engine):
    pool = pool_engine.slots(1)
    pool.admit(0, [1, 2], max_new=2)
    with pytest.raises(ValueError, match="occupied"):
        pool.admit(0, [3, 4])
    pool.evict(0)
    with pytest.raises(ValueError, match="empty prompt"):
        pool.admit(0, [])
    with pytest.raises(ValueError, match="max_len"):
        pool.admit(0, [1] * 30, max_new=8)
    with pytest.raises(ValueError, match="no active slot"):
        pool.step()
    with pytest.raises(ValueError, match="n_slots"):
        pool_engine.slots(0)


def test_slot_pool_sampling_is_slot_independent(pool_engine):
    """temperature > 0 draws key on (seed, uid, n_generated), so a request
    samples the same path whichever slot it lands in."""
    out = {}
    for slot in (0, 1):
        pool = pool_engine.slots(2, max_len=16)
        pool.temperature, pool.seed = 0.8, 7
        toks = [pool.admit(slot, [3, 4, 5], uid=42, max_new=4)]
        for _ in range(3):
            toks.append(int(pool.step()[slot]))
        out[slot] = toks
    assert out[0] == out[1]


def test_slot_pool_runs_the_hybrid_model():
    """Per-slot positions through attention and Mamba layers at once: the
    jamba smoke model's slots match their solo runs too."""
    eng = Engine(tt.init_lm(treg.get("jamba-v0.1-52b").smoke, seed=1, device="cpu"),
                 Runtime(mamba_chunk=4), max_len=24)
    pool = eng.slots(2)
    a = [pool.admit(0, [7, 8, 9, 10, 11], max_new=4)]
    b = [pool.admit(1, [3, 4], max_new=4)]
    for _ in range(3):
        out = pool.step()
        a.append(int(out[0]))
        b.append(int(out[1]))
    np.testing.assert_array_equal(a, eng.generate([[7, 8, 9, 10, 11]], max_new=4).tokens[0])
    np.testing.assert_array_equal(b, eng.generate([[3, 4]], max_new=4).tokens[0])


# ================================================================== launcher
def _run(argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        eng = serve.main(argv)
    return eng, buf.getvalue()


def test_launcher_serves_on_the_cpu():
    eng, out = _run(["--arch", "jamba-v0.1-52b", "--device", "cpu", "--requests", "3",
                     "--max-new", "4"])
    assert isinstance(eng, Engine) and eng.cfg == treg.get("jamba-v0.1-52b").smoke
    assert eng.device == torch.device("cpu") and not eng.rt.use_pallas
    lines = out.splitlines()
    assert lines[0].startswith("serve: jamba-smoke (8 layers, ")
    assert "3 requests x 4 new tokens" in lines[0] and "tokens/s" in lines[0]
    assert [l.split(":")[0] for l in lines[1:]] == ["req0", "req1", "req2"]
    # the same seed gives the same weights and prompts: --kernels (the plain
    # versions on the CPU) serves the same greedy tokens
    eng_k, out_k = _run(["--arch", "jamba-v0.1-52b", "--device", "cpu", "--requests", "3",
                         "--max-new", "4", "--kernels"])
    assert eng_k.rt.attn_impl == "pallas" and eng_k.rt.use_pallas
    assert out_k.splitlines()[1:] == lines[1:]


def test_launcher_cuts_the_full_config_and_refuses_what_it_cannot_serve():
    ap = serve.parser()
    with pytest.raises(SystemExit), contextlib.redirect_stderr(io.StringIO()):
        serve.main(["--arch", "granite-3-8b", "--periods", "1", "--device", "cpu"])
    args = ap.parse_args(["--arch", "jamba-v0.1-52b", "--full", "--periods", "1", "--kernels"])
    assert args.device == "cuda:0" and args.full and args.periods == 1 and args.kernels
    assert (args.requests, args.max_new, args.temperature) == (8, 32, 0.0)
    # xlstm serves (tests/test_torch_xlstm.py); the architectures that take a
    # frontend's embeddings are driven through prefill and decode_step
    for arch in ("seamless-m4t-large-v2", "qwen2-vl-2b"):
        with pytest.raises(ValueError, match="embeddings"):
            serve.main(["--arch", arch, "--device", "cpu"])


def test_launcher_asks_for_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("this check needs a machine without a CUDA card")
    with pytest.raises(RuntimeError, match="--device cpu"):
        serve.main(["--arch", "granite-3-8b"])


# ============================================================== import guard
GUARD = """
import importlib, json, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")
         if not m.name.endswith("__main__")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "repro"))
print(json.dumps({"names": names, "bad": bad}))
"""


def test_no_module_of_the_port_imports_jax_or_the_jax_package():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", GUARD], capture_output=True, text=True,
                          env=env, cwd=ROOT, timeout=300)
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout)
    assert out["bad"] == []
    assert {"repro_torch.models.transformer", "repro_torch.serving.engine",
            "repro_torch.launch.serve", "repro_torch.kernels.ref",
            "repro_torch.configs.jamba_v0_1_52b", "repro_torch.api.cli"} <= set(out["names"])


def test_chip_smoke_and_the_serving_side_import_no_jax_and_compile_nothing():
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            names.add(node.module or "")
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module":
            names |= {a.value for a in node.args if isinstance(a, ast.Constant)}
    assert not {n for n in names if n.split(".")[0] in ("jax", "jaxlib", "repro")}, names
    # the model and serving path runs eagerly: no torch.compile anywhere in it
    for sub in ("models", "serving", "launch", "configs"):
        for path in (ROOT / "src" / "repro_torch" / sub).rglob("*.py"):
            assert "torch.compile" not in path.read_text(), path
