"""The dry-run's counter (``repro_torch.utils.op_cost.OpCost``) on its own.

The eager counterpart of ``tests/test_hlo_cost.py``: a matmul's FLOPs, a
Python loop of L blocks counted as L blocks (an eager step runs every
iteration, so there is no trip count to recover), what a slice and an
in-place cache write charge, collectives on a fake 2×2 process group,
peak live bytes of a known sequence, and K1 through its shape rule.  No
tolerance: every count is an integer the test works out by hand.
"""

from __future__ import annotations

import pytest
import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.kernels.tree_eval import kernel as K
from repro_torch.kernels.tree_eval import ops
from repro_torch.launch.dryrun import fake_process_group
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.roofline import tree_eval_cost
from repro_torch.parallel import sharding as shd
from repro_torch.utils.op_cost import OpCost, tensor_bytes

F32 = 4


def count(fn, *args, track=()):
    """(``fn(*args)``, its OpCost), ``track``'s tensors live from the start."""
    with OpCost() as cost:
        cost.track(*track)
        out = fn(*args)
    return out, cost


@pytest.fixture
def fake():
    with FakeTensorMode() as mode:
        yield mode


@pytest.mark.parametrize("fake_tensors", [False, True], ids=["cpu", "fake"])
def test_matmul_flops_and_bytes(fake_tensors):
    m, k, n = 8, 32, 16

    def run():
        a, b = torch.ones(m, k), torch.ones(k, n)
        return count(lambda: a @ b, track=(a, b))[1]

    if fake_tensors:
        with FakeTensorMode():
            cost = run()
    else:
        cost = run()
    assert cost.flops == 2 * m * k * n
    assert cost.bytes == F32 * (m * k + k * n + m * n)
    assert cost.peak_bytes == F32 * (m * k + k * n + m * n)


def test_a_loop_of_blocks_counts_every_iteration(fake):
    ws = torch.empty(12, 64, 64)
    x = torch.empty(16, 64)

    def blocks(n):
        y = x
        for i in range(n):
            y = torch.tanh(y @ ws[i])
        return y

    one, twelve = count(blocks, 1)[1], count(blocks, 12)[1]
    assert one.flops == 2 * 16 * 64 * 64
    assert twelve.flops == 12 * one.flops
    assert twelve.bytes == 12 * one.bytes
    assert twelve.ops == 12 * one.ops


def test_a_slice_charges_what_it_touches(fake):
    x = torch.empty(1024, 256)
    cost = count(lambda: x[:8].clone())[1]
    assert cost.bytes == 2 * 8 * 256 * F32          # read the slice, write its copy
    rows = torch.zeros(8, dtype=torch.long)
    gathered = count(lambda: x[rows])[1]
    assert gathered.bytes == 2 * 8 * 256 * F32      # a gather charges its rows, not the table


def test_an_in_place_cache_write_charges_twice_the_update(fake):
    cache = torch.empty(4, 32_768, 8, 128, dtype=torch.bfloat16)
    update = torch.empty(4, 1, 8, 128, dtype=torch.bfloat16)
    cost = count(lambda: cache.narrow(1, 100, 1).copy_(update))[1]
    assert cost.bytes == 2 * tensor_bytes(update)
    assert cost.peak_bytes == 0                     # nothing new is allocated


def test_an_expanded_operand_counts_its_storage_once(fake):
    row = torch.empty(1, 64)
    cost = count(lambda: row.expand(128, 64) + 1.0)[1]
    assert cost.bytes == F32 * (64 + 128 * 64)


def test_peak_live_bytes_of_a_known_sequence():
    n = 1000

    def seq(a):
        b = a * 2            # a + b live
        del a
        c = b + 1            # b + c live (a is still held by the caller)
        del b
        d = c.sum()
        return c, d

    a = torch.ones(n)
    out, cost = count(seq, a, track=(a,))
    # a (tracked), b, c alive at once after c: 3n floats; then b goes
    assert cost.peak_bytes == 3 * n * F32
    del out
    assert cost.live_bytes == n * F32              # only a, which the test still holds


def test_collectives_on_a_fake_2x2_mesh_charge_by_the_hlo_convention():
    with fake_process_group(4):
        mesh = make_mesh((2, 2), ("data", "model"), device_type="cpu")
        with FakeTensorMode():
            local = torch.empty(32, 64)
            sharded = DTensor.from_local(local, mesh, [Shard(0), Replicate()], run_check=False,
                                         shape=(64, 64), stride=(64, 1))
            with OpCost() as gather:
                sharded.redistribute(mesh, [Replicate(), Replicate()]).to_local()
            partial = DTensor.from_local(torch.empty(64, 64), mesh, [Partial(), Replicate()], run_check=False,
                                         shape=(64, 64), stride=(64, 1))
            with OpCost() as scatter:
                partial.redistribute(mesh, [Shard(0), Replicate()]).to_local()
            shards = shd.BatchShards(mesh, (0,))
            with OpCost() as reduce:
                shards.all_reduce(torch.zeros(10))
    assert not dist.is_initialized()
    assert gather.coll_count == {"all-gather": 1}
    assert gather.coll_bytes["all-gather"] == 64 * 64 * F32        # the gathered result
    assert scatter.coll_count == {"reduce-scatter": 1}
    assert scatter.coll_bytes["reduce-scatter"] == 64 * 64 * F32   # the operand
    assert reduce.coll_count == {"all-reduce": 1}
    assert reduce.coll_bytes["all-reduce"] == 10 * F32


@pytest.mark.parametrize("fake_tensors", [False, True], ids=["cpu", "fake"])
def test_a_dtensor_op_counts_its_local_work_whatever_dtensor_has_cached(fake_tensors):
    """DTensor runs an op it has not seen before once more on global-shape
    fake tensors to learn its output; that run is not counted."""
    with fake_process_group(4):
        mesh = make_mesh((2, 2), ("data", "model"), device_type="cpu")
        with FakeTensorMode() if fake_tensors else torch.no_grad():
            costs = []
            for _ in range(2):      # the first call fills DTensor's cache, the second hits it
                a = DTensor.from_local(torch.ones(32, 32), mesh, [Shard(0), Shard(1)], run_check=False,
                                       shape=(64, 64), stride=(64, 1))
                with OpCost() as cost:
                    a * 3.0 + a.rsqrt()
                costs.append((cost.ops, cost.bytes))
    assert costs[0] == costs[1] == (3, F32 * 32 * 32 * (2 + 2 + 3))


def test_the_fake_process_group_is_destroyed_when_the_block_fails():
    with pytest.raises(ZeroDivisionError):
        with fake_process_group(4):
            1 / 0
    assert not dist.is_initialized()


@pytest.mark.parametrize("jump_mode", ["gather", "onehot"])
def test_k1_on_fake_tensors_gives_its_shape_and_tree_eval_cost_bytes(fake, jump_mode):
    m, a, n = 4096, 63, 127
    tree = ops.PackedTree.shapes_only(n, a, 6, "cpu")
    records = torch.empty(m, a)
    out, cost = count(lambda: K.speculative(records, tree.attr_idx, tree.attr_select, tree.threshold,
                                            tree.child, tree.class_val, total_jumps=3, jump_mode=jump_mode,
                                            block_m=0))
    assert out.shape == (m,) and out.dtype == torch.int32
    assert cost.k1 == 1 and cost.flops == 0
    assert cost.bytes == tree_eval_cost(m, a, 1, n, 0)["bytes"]


def test_k1_on_meta_tensors_gives_its_shape():
    tree = ops.PackedTree.shapes_only(15, 7, 3, "meta")
    out = K.speculative(torch.empty(100, 7, device="meta"), tree.attr_idx, tree.attr_select, tree.threshold,
                        tree.child, tree.class_val, total_jumps=2, jump_mode="onehot", block_m=0)
    assert out.shape == (100,) and out.dtype == torch.int32 and out.is_meta


def test_k1_is_one_operator_with_a_shape_rule():
    assert hasattr(torch.ops.repro_torch, "speculative")
    with pytest.raises(ValueError, match="unknown jump_mode"):
        tree = ops.PackedTree.shapes_only(15, 7, 3, "meta")
        K.speculative(torch.empty(4, 7, device="meta"), tree.attr_idx, tree.attr_select, tree.threshold,
                      tree.child, tree.class_val, total_jumps=2, jump_mode="nope", block_m=0)


# ---------------------------------------------------------------------------
# on the card (marked gpu): torch there is another version than here
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    """The card, for tests marked ``gpu``; decided when the test runs."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
def test_counts_on_the_card_equal_counts_on_fake_cuda_tensors(cuda_device):
    def step():
        w = torch.ones(64, 64, device="cuda", requires_grad=True)
        x = torch.ones(16, 64, device="cuda")
        cache = torch.zeros(4, 32, 64, device="cuda")
        with OpCost() as cost:
            cost.track(w, x, cache)
            y = x
            for _ in range(3):
                y = torch.tanh(y @ w)
            y.sum().backward()
            cache.narrow(1, 5, 1).copy_(y[:4, None])
        return cost

    real = step()
    with FakeTensorMode():
        fake = step()
    # FLOPs, bytes and peak; not the op count (the card runs one more op that moves nothing)
    assert (real.flops, real.bytes, real.peak_bytes) == (fake.flops, fake.bytes, fake.peak_bytes)
    # 3 products forward, 5 backward (the first layer's input takes no gradient)
    assert real.flops == 8 * 2 * 16 * 64 * 64


@pytest.mark.gpu
def test_k1_on_fake_cuda_tensors_is_checked_as_a_launch_is(cuda_device):
    with FakeTensorMode():
        tree = ops.PackedTree.shapes_only(127, 63, 6, "cuda")
        records = torch.empty(512, 63, device="cuda")
        tabs = (tree.attr_idx, tree.attr_select, tree.threshold, tree.child, tree.class_val)
        bm = ops.choose_block_m(127, 63, algorithm="speculative", jump_mode="onehot")
        out = K.speculative(records, *tabs, total_jumps=3, jump_mode="onehot", block_m=bm)
        assert out.shape == (512,) and out.dtype == torch.int32 and out.device.type == "cuda"
        with pytest.raises(K.TileError):
            K.speculative(records, *tabs, total_jumps=3, jump_mode="onehot", block_m=4096)


@pytest.mark.gpu
def test_the_dry_run_plans_on_fake_cuda_tensors_and_leaves_no_process_group(cuda_device):
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.launch import dryrun

    assert dryrun.fake_device_type() == "cuda"
    before = torch.cuda.memory_allocated()
    row = dryrun.run_cell("granite-moe-3b-a800m", ShapeConfig("decode_s", 64, 8, "decode"), mesh="2x2",
                          cfg=get_smoke_config("granite-moe"), verbose=False)
    assert row["k1_ops"] == get_smoke_config("granite-moe").n_layers
    assert torch.cuda.memory_allocated() == before          # nothing was allocated on the card
    assert not dist.is_initialized()
