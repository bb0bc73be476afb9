"""``optlevels.incremental_opcount``: Inductor lowers a long O3 chain with
the same op counts, so the same decisions and the same generated code,
while tracing far fewer ops (on the CPU, where Inductor emits C++; the
decisions do not depend on the device, and on the card ``chip_smoke.py``
holds each row's SASS a step)."""
from unittest import mock

import pytest
import torch
from torch._inductor import ir
from torch._inductor.ops_handler import OpCounterCSE
from torch._inductor.utils import run_and_get_code

from repro_torch.core import chains, measure, optlevels


def _compile(name: str, n: int):
    """Every node's op count in call order, the ops the counters traced,
    the generated code and the chain's result."""
    counts, traced = [], [0]

    def recorded(self):
        r = count(self)
        counts.append((r.num_ops, tuple(r.read_buffers), r.nontrivial_read_count,
                       tuple(sorted(r.used_ops))))
        return r

    def counted(self, val):
        traced[0] += 1
        return update(self, val)

    spec = chains.spec_by_name(name)
    fn = measure.compile_chain(spec, n, "O3", "cpu")     # compiles at its first call
    count, update = ir.Loops.inner_fn_opcount, OpCounterCSE._update_count
    ir.Loops.inner_fn_opcount, OpCounterCSE._update_count = recorded, counted
    try:
        with torch._inductor.config.patch(fx_graph_cache=False), \
                torch._functorch.config.patch(enable_autograd_cache=False):
            out, code = run_and_get_code(fn, spec.carry("cpu"), *spec.operand_tensors("cpu"))
    finally:
        ir.Loops.inner_fn_opcount, OpCounterCSE._update_count = count, update
    # the first line names the compile's AOT id, which counts compiles
    return counts, traced[0], [c.split("\n", 1)[1] for c in code], out


@pytest.mark.parametrize("name", ["mad.cc", "fma.float16", "xor"])
def test_incremental_opcount_keeps_every_count_and_the_code(name):
    """160 steps: past the 100 ops at which Inductor stores an inlined
    expression as a buffer, so the chain is stored several times."""
    own = [getattr(f, "inductor_own", f)
           for f in (ir.Loops.inner_fn_opcount, ir.Pointwise.make_loader)]
    # Inductor's own methods for this test, whatever an earlier compile in
    # this process installed; put back as they were when it ends
    with mock.patch.object(ir.Loops, "inner_fn_opcount", own[0]), \
            mock.patch.object(ir.Pointwise, "make_loader", own[1]):
        # compile_at_level installs it: keep Inductor's own for this compile
        with mock.patch.object(optlevels, "incremental_opcount", lambda: None):
            counts, traced, code, out = _compile(name, 160)
        optlevels.incremental_opcount()
        assert ir.Loops.inner_fn_opcount.inductor_own is own[0]
        counts_i, traced_i, code_i, out_i = _compile(name, 160)
    assert counts_i == counts and len(counts) >= 160
    assert code_i == code and torch.equal(out_i, out)
    assert traced_i * 4 < traced, (traced_i, traced)


def test_compile_workers_for_takes_the_cpus_the_process_may_use():
    """Compile workers: one per CPU in the process's affinity mask
    (os.cpu_count() counts the machine's), no more than there are tasks,
    and none on the CPU, where the session compiles in its own process."""
    import os

    from repro_torch.api import session

    affinity = len(os.sched_getaffinity(0))
    assert session.compile_workers_for(torch.device("cuda"), 10_000) == affinity
    assert session.compile_workers_for(torch.device("cuda"), 1) == 1
    assert session.compile_workers_for(torch.device("cpu"), 5) == 0
