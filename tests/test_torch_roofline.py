"""repro_torch's roofline: the op counter over eager steps and the H100
terms.

``roofline/hlo_cost.py``'s ``OpCounter`` counts every op that runs, so a
Python loop of matmuls is counted once an iteration, as the reference's
loop-aware HLO parser counts ``lax.scan`` bodies (tests/test_roofline.py):
``L * 2 * 128**3`` flops for ``L`` looped (128, 128) matmuls and
``15 * 2 * 64**3`` for 5 x 3 nested ones.  The roofline terms use the H100
data-sheet constants.
"""
import pytest
import torch

from repro.roofline import analysis as ranalysis
from repro_torch.kernels import flash_attention as F
from repro_torch.roofline import analysis, hlo_cost


def _loop_matmul(L, n=128):
    x, w = torch.randn(n, n), torch.randn(n, n)
    with hlo_cost.OpCounter() as c:
        for _ in range(L):
            x = torch.tanh(x @ w)
    return c


@pytest.mark.parametrize("L", [3, 8])
def test_loop_flops_exact(L):
    c = _loop_matmul(L)
    assert c.flops == L * 2 * 128 ** 3
    # each iteration: the matmul (two inputs, one output) and the tanh
    assert c.bytes == L * (3 + 2) * 128 * 128 * 4
    assert c.ops == 2 * L


def test_nested_loops_multiply():
    x, w = torch.randn(64, 64), torch.randn(64, 64)
    with hlo_cost.OpCounter() as c:
        for _ in range(5):
            for _ in range(3):
                x = torch.tanh(x @ w)
    assert c.flops == 15 * 2 * 64 ** 3


def test_backward_and_views_are_counted():
    """The backward's matmuls count too (2x the forward's for x @ w with
    both inputs requiring grad); a view moves no byte."""
    x = torch.randn(32, 64, requires_grad=True)
    w = torch.randn(64, 16, requires_grad=True)
    with hlo_cost.OpCounter() as c:
        (x @ w).sum().backward()
    assert c.flops == 3 * 2 * 32 * 64 * 16
    with hlo_cost.OpCounter() as v:
        x.detach().reshape(64, 32).transpose(0, 1)
    assert v.bytes == 0


def test_live_bytes_peak_and_free():
    with hlo_cost.OpCounter() as c:
        a = torch.ones(1024)          # 4 KiB alive
        b = a + 1                     # 8 KiB
        del a, b
        d = torch.ones(256)
    assert c.peak_live == 2 * 4096 and c.live == 1024
    del d


def test_collectives_are_recorded_only_while_counting():
    """The c10d ops of a fake (2, 2, 1) mesh's groups (rank 0 of 4, as the
    dry-run runs): each counted by kind with its output bytes (a send's
    input) under the mesh axis of its group; a one-member group, a
    barrier, a receive and a collective outside the counter count
    nothing."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.launch import dryrun

    dryrun.fake_process_group(4)
    try:
        mesh = init_device_mesh("cpu", (2, 2, 1), mesh_dim_names=("pod", "data", "model"))
        x = torch.ones(256, 128)
        dist.all_reduce(x, group=mesh.get_group(0))                  # not counting
        with hlo_cost.OpCounter(mesh) as c:
            dist.all_gather([torch.empty_like(x) for _ in range(2)], x,
                            group=mesh.get_group("data"))
            dist.all_reduce(torch.ones(2), group=mesh.get_group("pod"))
            dist.reduce_scatter(torch.empty(64, 128), [torch.ones(64, 128)] * 2,
                                group=mesh.get_group("data"))
            dist.all_to_all_single(torch.empty(8), torch.ones(8), group=mesh.get_group("pod"))
            g = mesh.get_group("data")
            ops = [dist.P2POp(dist.isend, torch.ones(4), dist.get_global_rank(g, 1), g),
                   dist.P2POp(dist.irecv, torch.empty(4), dist.get_global_rank(g, 1), g)]
            for req in dist.batch_isend_irecv(ops):
                req.wait()
            dist.all_reduce(x, group=mesh.get_group("model"))         # one member
            dist.all_gather([torch.empty(8, 128) for _ in range(4)], torch.ones(8, 128))  # world
            dist.barrier()
    finally:
        dist.destroy_process_group()
    assert c.coll == {"all-reduce": 8, "all-gather": 256 * 256 * 4 + 32 * 128 * 4,
                      "reduce-scatter": 64 * 128 * 4, "all-to-all": 32, "collective-permute": 16}
    assert c.coll_by_axis["data"]["all-gather"] == 256 * 256 * 4
    assert c.coll_by_axis["data"]["reduce-scatter"] == 64 * 128 * 4
    assert c.coll_by_axis["pod"]["all-reduce"] == 8 and c.coll_by_axis["pod"]["all-to-all"] == 32
    assert c.coll_by_axis["data"]["collective-permute"] == 16       # the send; the recv is not
    assert c.coll_by_axis["group"]["all-gather"] == 32 * 128 * 4
    assert set(c.coll_by_axis) == {"data", "pod", "group"}
    assert analysis.wire_bytes(c.coll) == 16 + 256 * 256 * 4 + 32 * 128 * 4 + 64 * 128 * 4 + 48


@pytest.mark.parametrize("causal,window", [(True, 0), (False, 0), (True, 5)])
def test_flash_flops_count_the_visible_pairs(causal, window):
    """The flash op's registered formula: 4 flops a (query, key) pair a head
    dim, over the pairs its masks leave."""
    q, k = torch.randn(2, 12, 4, 16), torch.randn(2, 12, 2, 16)
    pairs = sum(1 for i in range(12) for j in range(12)
                if (not causal or j <= i) and (not window or i - j < window))
    assert F.visible_pairs(12, 12, causal, window) == pairs
    flops = torch.utils.flop_counter.flop_registry[torch.ops.repro_torch.flash_attention_fwd](
        q, k, k, causal, window, out_val=q)
    assert flops == 4 * 2 * 4 * 16 * pairs


def test_h100_constants_are_data_sheet_values():
    assert analysis.PEAK_FLOPS == 989e12
    assert analysis.HBM_BW == 3.35e12
    assert analysis.LINK_BW == 450e9
    assert analysis.PEAK_FLOPS != ranalysis.PEAK_FLOPS


def test_roofline_terms_and_bottleneck():
    rl = analysis.Roofline(
        flops=989e12, hbm_bytes=3.35e12 * 2, coll_bytes=0,
        collectives={}, model_flops=989e12 * 256, chips=256,
    )
    assert abs(rl.t_compute - 1.0) < 1e-9
    assert abs(rl.t_memory - 2.0) < 1e-9
    assert rl.bottleneck == "memory"
    assert abs(rl.roofline_fraction - 0.5) < 1e-9
    assert abs(rl.useful_flops_ratio - 1.0) < 1e-9
    # the eager ops' bytes are a ceiling: they decide neither the bottleneck
    # nor the fraction
    rl = analysis.Roofline(flops=989e12, hbm_bytes=3.35e12 / 2, coll_bytes=0, collectives={},
                           model_flops=989e12, chips=1, hbm_bytes_eager=3.35e12 * 4)
    assert rl.bottleneck == "compute" and abs(rl.t_memory_eager - 4.0) < 1e-9
    assert abs(rl.roofline_fraction - 1.0) < 1e-9
    rl = analysis.Roofline(flops=0, hbm_bytes=0, coll_bytes=450e9 * 3, collectives={},
                           model_flops=0, chips=1)
    assert rl.bottleneck == "collective" and abs(rl.t_collective - 3.0) < 1e-9
    assert rl.roofline_fraction == 0.0
    d = rl.to_dict()
    # the reference's keys but XLA's own cost, the bytes by mesh axis and
    # the eager ceiling
    assert set(d) == {k for k in ranalysis.Roofline(0, 0, 0, {}, 0, 1).to_dict()
                      if k != "xla_cost"} | {"collectives_by_axis", "hbm_bytes_eager_per_device",
                                             "t_memory_eager_s"}


def test_wire_bytes_and_floor_fraction_match_reference():
    coll = {"all-reduce": 10, "all-gather": 7, "reduce-scatter": 3, "all-to-all": 2,
            "collective-permute": 1}
    assert analysis.wire_bytes(coll) == ranalysis.wire_bytes(coll)
    rl = analysis.Roofline(flops=0, hbm_bytes=3.35e12, coll_bytes=0, collectives={},
                           model_flops=0, chips=1)
    assert abs(analysis.decode_floor_fraction(3.35e12 / 4, rl) - 0.25) < 1e-12
    empty = analysis.Roofline(0, 0, 0, {}, 0, 1)
    assert analysis.decode_floor_fraction(1.0, empty) == 0.0


def test_analyze_reads_a_counter():
    """The memory floor is the arguments read once plus the peak of the
    temporaries; the counter's bytes of every op are the eager ceiling."""
    c = _loop_matmul(3)
    hlo = analysis.analyze(c, model_flops=6.0, chips=2, argument_bytes=1000)
    assert hlo.flops == c.flops and hlo.hbm_bytes_eager == c.bytes
    assert hlo.hbm_bytes == 1000 + c.peak_live and c.peak_live > 0
    assert hlo.hbm_bytes < hlo.hbm_bytes_eager
    assert hlo.collectives == dict.fromkeys(hlo_cost.COLL_KINDS, 0)


def test_kernel_wrappers_take_fake_cuda_tensors_to_their_operators():
    """A fake CUDA tensor (the dry-run's) reaches the flash and planes
    kernels' operators, whose fake implementations give the outputs'
    shapes: nothing launches, and the flash op's flops are counted."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.kernels import ops, planes

    ops.reset_launch_counts()
    with FakeTensorMode():
        q = torch.empty(2, 64, 4, 16, device="cuda")
        k = torch.empty(2, 64, 2, 16, device="cuda")
        with hlo_cost.OpCounter() as c:
            o = F.flash_attention(q, k, k, causal=True)
            mu, sexp, pl = planes.planes_encode(torch.empty(10, 64, device="cuda"), 2)
            d = planes.planes_decode(mu, sexp, pl)
    assert o.shape == q.shape and o.device.type == "cuda"
    assert (mu.shape, mu.dtype, sexp.dtype, pl.shape, pl.dtype) == (
        (10,), torch.float32, torch.int32, (2, 10, 64), torch.uint8)
    assert d.shape == (10, 64) and d.dtype == torch.float32
    assert c.flops == 4 * 2 * 4 * 16 * F.visible_pairs(64, 64, True, 0)
    assert not any(ops.launch_counts().values())
    with pytest.raises(ValueError, match="q on meta"):
        F.flash_attention(*(torch.empty(1, 8, 2, 16, device="meta"),) * 3)
