"""The port's `parallel/` (`distributed.py`, `mesh.py`) against the JAX
package's:

- the JAX package's test_distributed_single_process cases, on both
  packages in one process (no process group);
- `shard_data_for_process` for 1-4 ranks and several data lengths, equal
  to JAX's slices;
- `shard_batch`: each rank's rows of an episode batch against the data of
  each addressable shard of JAX `shard_batch` on `make_mesh(n_devices=2)`,
  the leaves JAX replicates (`feat_noise`, a bank of its own size) whole;
- every collective across two gloo processes (`torch_dist_rig`): the
  object gather, sums, the metrics' reduction, the gradient all-reduce
  with a gradient missing on one rank, the differentiable row gather and
  its backward, broadcasts and the model replication;
- without a group: `init_distributed` for one process builds none, the
  collectives are the identity, and the device and seed of a rank."""
import numpy as np
import pytest
import jax
import torch

from vln_goat_tpu.parallel import distributed as jdist
from vln_goat_tpu.parallel.mesh import make_mesh as jax_mesh
from vln_goat_tpu.parallel.mesh import shard_batch as jax_shard
from vln_goat_tpu_torch.entry import build_train_flagship
from vln_goat_tpu_torch.parallel import distributed as pdist
from vln_goat_tpu_torch.parallel.mesh import Mesh, make_mesh, shard_batch
import torch_dist_rig as R

DATA = list(range(10))
SINGLE = [
    ("all_gather_objects", ({"a": 1},)),
    ("merge_dist_results", ([[1, 2], [3]],)),
    ("shard_data_for_process", (DATA, 0, 1)),
    ("shard_data_for_process", (DATA, 0, 3)),
    ("shard_data_for_process", (DATA, 2, 3)),
]


@pytest.mark.parametrize("fn,args", SINGLE,
                         ids=[f"{f}-{i}" for i, (f, _) in enumerate(SINGLE)])
def test_single_process_cases_match_jax(fn, args):
    assert getattr(pdist, fn)(*args) == getattr(jdist, fn)(*args)


@pytest.mark.parametrize("n", [1, 2, 3, 4])
@pytest.mark.parametrize("length", [0, 3, 10, 13])
def test_shard_data_for_process_matches_jax(n, length):
    data = list(range(length))
    parts = [pdist.shard_data_for_process(data, t, n) for t in range(n)]
    assert parts == [jdist.shard_data_for_process(data, t, n)
                     for t in range(n)]
    assert sum(parts, []) == data


@pytest.fixture(scope="module")
def episode_batch():
    _, batcher = build_train_flagship("cpu", tiny=True, batch_size=8,
                                      dropout=False)
    batch = R.numpy_tree(batcher.next_batch()[1])
    batch["feat_noise"] = np.arange(16, dtype=np.float32)
    batch["bank"] = np.ones((5, 4), np.float32)
    return batch


@pytest.mark.parametrize("rank", [0, 1])
def test_shard_batch_matches_jax_shards(episode_batch, rank):
    mesh = jax_mesh(n_devices=2)
    dev = mesh.devices.reshape(-1)[rank]
    ref = jax_shard(episode_batch, mesh)
    got = shard_batch(R.tensors(episode_batch),
                      Mesh(rank, 2, torch.device("cpu")))
    assert set(got) == set(ref)
    for k, arr in ref.items():
        shard = [s for s in arr.addressable_shards if s.device == dev][0]
        assert np.array_equal(got[k].numpy(), np.asarray(shard.data)), k
    for k in ("feat_noise", "bank"):
        assert np.array_equal(got[k].numpy(), episode_batch[k])
    assert got["scan_idx"].shape[0] == 4


def test_shard_batch_indivisible_raises(episode_batch):
    with pytest.raises(ValueError, match="does not divide"):
        shard_batch(R.tensors(episode_batch),
                    Mesh(0, 3, torch.device("cpu")))


def test_shard_batch_pretraining_rows():
    batch = {"txt_ids": np.arange(12).reshape(6, 2),
             "bank": np.zeros((4, 3))}
    got = shard_batch(batch, Mesh(2, 3, torch.device("cpu")))
    assert got["txt_ids"].tolist() == [[8, 9], [10, 11]]
    assert got["bank"].shape == (4, 3)


@pytest.fixture(scope="module")
def ranks():
    return R.run_ranks(R.collectives, 2)


def test_group_size_and_index(ranks):
    assert [(r["count"], r["index"]) for r in ranks] == [(2, 0), (2, 1)]
    assert [r["mesh"] for r in ranks] == [(0, 2, "cpu"), (1, 2, "cpu")]


def test_all_gather_objects_across_processes(ranks):
    for r in ranks:
        assert r["gather"] == [{"rank": 0}, {"rank": 1}, {"rank": 1}]


def test_sums_and_metrics(ranks):
    for r in ranks:
        assert r["sum"] == [3.0, 10.0]
        assert r["metrics"] == {"loss": 2.5, "node_overflow": 7.0,
                                "steps": 5.0}


def test_grads_mean_with_a_missing_one(ranks):
    for r in ranks:
        assert r["grads"] == ([1.5] * 3, [2.0] * 2)


def test_gather_rows_and_its_backward(ranks):
    for rank, r in enumerate(ranks):
        rows, grad = r["gather_rows"]
        assert rows == [[0.0] * 3] * 2 + [[1.0] * 3] * 2
        # every rank's loss weighs the gathered rows by rank + 1: 1 + 2
        assert grad == [[3.0] * 3] * 2


def test_broadcast_and_replicate(ranks):
    for r in ranks:
        assert r["broadcast"] == {"from": 0}
        assert r["replicated"] == [[0.0, 0.0], [0.0, 0.0]]


def test_without_a_group():
    assert not pdist.active()
    assert pdist.init_distributed("localhost:1", 1, 0, device="cpu") is False
    assert not pdist.active()
    assert (pdist.process_count(), pdist.process_index()) == (1, 0)
    t = torch.tensor([2.0])
    assert pdist.all_reduce_sum(t) is t and t.item() == 2.0
    p = torch.nn.Parameter(torch.zeros(2))
    pdist.all_reduce_grads([p])
    assert p.grad is None
    m = {"loss": torch.tensor(1.5)}
    assert pdist.reduce_metrics(m) is m
    x = torch.ones(2, 2)
    assert pdist.gather_rows(x) is x
    assert make_mesh("cpu") == Mesh(0, 1, torch.device("cpu"))
    batch = {"scan_idx": torch.arange(3)}
    assert shard_batch(batch, make_mesh("cpu")) is batch


def test_rank_device_and_seed():
    assert pdist.rank_device("cpu", 3) == "cpu"
    assert pdist.rank_device("cuda:1", 3) == "cuda:1"
    assert pdist.rank_seed(7, 0) == 7
    seeds = {pdist.rank_seed(7, r) for r in range(4)}
    assert len(seeds) == 4
