"""Port parity: ``parallel/mesh.py`` and the multi-device data streams
against the JAX package, with no process group (the multi-rank runs are in
``tests/test_torch_distributed_*.py``).

- the rank -> (data, model) map equals the device grid of JAX's
  ``create_mesh`` for 1x1, 2x1, 2x2 and 4x2, and a grid that does not fit
  raises in both;
- ``maybe_initialize_distributed``'s modes and errors are JAX's;
- ``ArrayDataset.index_batches(shard=(k, n))`` and ``batches`` equal JAX's
  over several (k, n), seeds and epochs, with the same errors;
- ``sharded_index_batches`` equals JAX's draw for draw, with its
  empty-shard error;
- the pieces of the trainer that need no group: a data rank's dropout
  masks are its rows of the global batch's, a store shard's rows are the
  whole store's, a ``mesh.shard_params`` rule that matches a parameter
  neither row-sharded read takes raises, and a global batch the data axis
  does not divide raises.
"""

import numpy as np
import pytest
import torch

from vqa_transfer_externaldata_torch.config import Config
from vqa_transfer_externaldata_torch.data import datasets as tds
from vqa_transfer_externaldata_torch.models.zoo import build_model
from vqa_transfer_externaldata_torch.ops import attention_resident as tar
from vqa_transfer_externaldata_torch.ops.layers import DataShardDropout
from vqa_transfer_externaldata_torch.parallel import mesh as tmesh
from vqa_transfer_externaldata_torch.parallel import trainer as ttr

torch.set_num_threads(2)

TINY = {
    "data.synthetic": True, "data.synthetic_layout": "joined",
    "data.synthetic_size": 64, "data.vocab_size": 64,
    "data.num_answers": 16, "data.grid_h": 3, "data.grid_w": 3,
    "data.feature_dim": 16, "data.pool5_dim": 16,
    "data.max_question_len": 6, "model.word_dim": 8, "model.rnn_dim": 8,
    "model.fusion_dim": 16, "model.att_hidden": 8, "model.answer_dim": 8,
    "model.dtype": "float32", "model.dropout": 0.0,
    "train.batch_size": 16, "train.device_data_cache": True,
}


@pytest.mark.parametrize("num_data,num_model", [(1, 1), (2, 1), (2, 2),
                                                (4, 2)])
def test_rank_grid_equals_jax_create_mesh(num_data, num_model):
    import jax

    from vqa_transfer_externaldata_tpu.config import Config as JaxConfig
    from vqa_transfer_externaldata_tpu.parallel.mesh import create_mesh

    over = {"mesh.num_data": num_data, "mesh.num_model": num_model}
    world = num_data * num_model
    jm = create_mesh(JaxConfig().replace_flat(over),
                     devices=jax.devices()[:world])
    assert jm.devices.shape == (num_data, num_model)
    cfg = Config().replace_flat(over)
    assert tmesh.mesh_shape(cfg, world) == (num_data, num_model)
    # num_data -1: the world over the model axis, as JAX's default.
    auto = Config().replace_flat({"mesh.num_model": num_model})
    assert tmesh.mesh_shape(auto, world) == (num_data, num_model)
    for rank in range(world):
        i, j = tmesh.rank_coords(rank, num_model)
        assert jm.devices[i, j].id == jax.devices()[rank].id


def test_grid_larger_than_the_world_raises_as_in_jax():
    import jax

    from vqa_transfer_externaldata_tpu.config import Config as JaxConfig
    from vqa_transfer_externaldata_tpu.parallel.mesh import create_mesh

    over = {"mesh.num_data": 2, "mesh.num_model": 2}
    with pytest.raises(AssertionError, match="needs 4 devices"):
        create_mesh(JaxConfig().replace_flat(over),
                    devices=jax.devices()[:2])
    with pytest.raises(ValueError, match="needs 4 ranks, have 2"):
        tmesh.mesh_shape(Config().replace_flat(over), 2)
    # Without a process group the mesh is one rank: a grid of more raises.
    with pytest.raises(ValueError, match="needs 2 ranks, have 1"):
        tmesh.create_mesh(Config().replace_flat({"mesh.num_model": 2}),
                          torch.device("cpu"))
    one = tmesh.create_mesh(None, torch.device("cpu"))
    assert (one.num_data, one.num_model, one.rank, one.distributed) == \
        (1, 1, 0, False)
    assert one.is_writer and one.backend is None


@pytest.mark.parametrize("mode", ["auto", "off", "bogus"])
def test_initialize_modes_equal_jax(mode, monkeypatch):
    from vqa_transfer_externaldata_tpu.parallel import mesh as jmesh

    for var in ("JAX_COORDINATOR_ADDRESS", "COORDINATOR_ADDRESS",
                "MEGASCALE_COORDINATOR_ADDRESS", "TPU_WORKER_HOSTNAMES",
                "WORLD_SIZE"):
        monkeypatch.delenv(var, raising=False)
    if mode == "bogus":
        with pytest.raises(ValueError) as jerr:
            jmesh.maybe_initialize_distributed(mode)
        with pytest.raises(ValueError) as terr:
            tmesh.maybe_initialize_distributed(mode)
        assert str(terr.value) == str(jerr.value)
        return
    # One process alone (auto) and off: neither starts anything.
    assert jmesh.maybe_initialize_distributed(mode) is False
    assert tmesh.maybe_initialize_distributed(mode) is False
    assert not torch.distributed.is_initialized()


def test_auto_mode_reads_torchrun_world(monkeypatch):
    """auto starts a group when WORLD_SIZE > 1 (torchrun), not at 1."""
    calls = []
    monkeypatch.setattr(tmesh.dist, "init_process_group",
                        lambda **kw: calls.append(kw))
    monkeypatch.setattr(tmesh.dist, "is_initialized",
                        lambda: len(calls) == 1)
    monkeypatch.setenv("WORLD_SIZE", "1")
    assert tmesh.maybe_initialize_distributed("auto") is False
    monkeypatch.setenv("WORLD_SIZE", "2")
    assert tmesh.maybe_initialize_distributed("auto", backend="gloo")
    assert calls == [{"backend": "gloo", "init_method": "env://"}]
    # A second call, while the group runs, does nothing.
    assert tmesh.maybe_initialize_distributed("on") is False
    calls.append(None)  # the group has ended
    cfg = Config().replace_flat({"mesh.coordinator_address": "host:1234",
                                 "mesh.num_processes": 4,
                                 "mesh.process_id": 3})
    assert tmesh.initialize_distributed_from(cfg, backend="gloo")
    assert calls[-1] == {"backend": "gloo", "init_method": "tcp://host:1234",
                         "world_size": 4, "rank": 3}


def _arrays(size):
    rng = np.random.default_rng(size)
    return {"a": rng.normal(size=(size, 3)).astype(np.float32),
            "b": np.arange(size, dtype=np.int32)}


@pytest.mark.parametrize("size,batch,shard", [
    (50, 8, (0, 2)), (50, 8, (1, 2)), (37, 12, (2, 3)), (64, 16, (3, 4)),
    (64, 16, None), (33, 4, (0, 1))])
@pytest.mark.parametrize("seed", [0, 7])
def test_index_batches_shard_equals_jax(size, batch, shard, seed):
    from vqa_transfer_externaldata_tpu.data import datasets as jds

    a = _arrays(size)
    want = jds.ArrayDataset(a).index_batches(batch, seed=seed, shard=shard)
    got = tds.ArrayDataset(a).index_batches(batch, seed=seed, shard=shard)
    # Several epochs: the boundaries of each rank's trimmed slice.
    for _ in range(3 * size // batch + 2):
        w, g = next(want), next(got)
        assert g.dtype == w.dtype == np.int32
        np.testing.assert_array_equal(g, w)
    bw = next(jds.ArrayDataset(a).batches(batch, seed=seed, shard=shard))
    bg = next(tds.ArrayDataset(a).batches(batch, seed=seed, shard=shard))
    for k in bw:
        np.testing.assert_array_equal(bg[k], bw[k])


@pytest.mark.parametrize("size,batch,shard,match", [
    (50, 9, (0, 2), "not divisible by process count 2"),
    (5, 8, (0, 2), "rows < batch_size 8")])
def test_index_batches_shard_errors_equal_jax(size, batch, shard, match):
    from vqa_transfer_externaldata_tpu.data import datasets as jds

    for mod in (jds, tds):
        with pytest.raises(ValueError, match=match):
            next(mod.ArrayDataset(_arrays(size)).index_batches(
                batch, shard=shard))


@pytest.mark.parametrize("n_shards,per_shard,seed", [(2, 8, 0), (8, 8, 3),
                                                     (3, 5, 11)])
def test_sharded_index_batches_equal_jax(n_shards, per_shard, seed):
    from vqa_transfer_externaldata_tpu.parallel import trainer as jtr

    owner = np.random.default_rng(seed).integers(0, 12, size=100) % n_shards
    want = jtr.sharded_index_batches(owner, n_shards, per_shard, seed)
    got = ttr.sharded_index_batches(owner, n_shards, per_shard, seed)
    for _ in range(40):  # past every shard's epoch boundary
        w, g = next(want), next(got)
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
        slots = g.reshape(n_shards, per_shard)
        for d in range(n_shards):
            assert (owner[slots[d]] == d).all()


def test_sharded_index_batches_empty_shard_raises_as_jax():
    from vqa_transfer_externaldata_tpu.parallel import trainer as jtr

    owner = np.array([0, 2, 0, 2])
    for mod in (jtr, ttr):
        with pytest.raises(ValueError, match=r"store shard\(s\) \[1\] own "
                                             "no dataset rows"):
            next(mod.sharded_index_batches(owner, 3, 2, 0))


def test_data_rank_dropout_masks_are_rows_of_the_global_mask():
    g = torch.Generator().manual_seed(5)
    whole = torch.rand((12, 7), generator=g) < 0.6
    parts = []
    for d in range(3):
        g = torch.Generator().manual_seed(5)
        parts.append(DataShardDropout(g, d, 3).keep((4, 7), torch.device(
            "cpu"), 0.6))
    torch.testing.assert_close(torch.cat(parts), whole, rtol=0, atol=0)


@pytest.mark.parametrize("quantize", ["", "int8"])
@pytest.mark.parametrize("chunk_rows", [2, 64])
def test_store_shard_rows_are_the_whole_stores(quantize, chunk_rows):
    # 11 rows over 4 shards: a tail shard of 2 rows in a 3-row block, in
    # chunks of 2 rows or in one chunk longer than any shard.
    grid = np.random.default_rng(0).normal(size=(11, 5, 16)).astype(
        np.float16)
    whole, scale = tar.prenormalize_store(grid, quantize=quantize,
                                          chunk_bytes=2 * 5 * 16 * 4)
    for d in range(4):
        part, s = tar.prenormalize_store(grid, quantize=quantize, shard=(d, 4),
                                         chunk_bytes=chunk_rows * 5 * 16 * 4)
        assert s == scale and part.shape == (3, 8, 16)
        rows = whole[d::4]
        torch.testing.assert_close(part[:rows.shape[0]], rows, rtol=0,
                                   atol=0)
        assert not part[rows.shape[0]:].any()


@pytest.mark.parametrize("rule,name", [("logit_bias", "logit_bias"),
                                       ("att_q", "att_q.weight")])
def test_shard_rule_on_an_unsupported_table_raises(rule, name, tmp_path):
    cfg = Config().replace_flat(dict(TINY, **{"mesh.shard_params": rule}))
    with pytest.raises(ValueError, match=name):
        ttr.Trainer(cfg, build_model(cfg), train_dir=str(tmp_path),
                    device="cpu")


def test_supported_tables_on_one_model_rank_stay_whole(tmp_path):
    cfg = Config().replace_flat(dict(
        TINY, **{"mesh.shard_params": "answer_embedding,word_emb"}))
    tr = ttr.Trainer(cfg, build_model(cfg), train_dir=str(tmp_path),
                     device="cpu")
    s = tr.init_state()
    assert s.params["answer_embedding"].shape == (16, 8)
    assert not tr.model.row_shards
    tr.close()


def test_global_batch_the_data_axis_does_not_divide_raises(tmp_path):
    cfg = Config().replace_flat(dict(TINY, **{"train.batch_size": 15}))
    mesh = tmesh.Mesh(2, 1, 0, 0, torch.device("cpu"))
    with pytest.raises(ValueError, match="divisible by the data-axis size"):
        ttr.Trainer(cfg, build_model(cfg), mesh=mesh,
                    train_dir=str(tmp_path))


def test_store_sharded_needs_the_device_cache(tmp_path):
    cfg = Config().replace_flat(dict(TINY, **{
        "train.store_sharded": True, "train.device_data_cache": False}))
    with pytest.raises(ValueError, match="needs train.device_data_cache"):
        ttr.Trainer(cfg, build_model(cfg), train_dir=str(tmp_path),
                    device="cpu")


def test_store_sharded_requires_the_fused_path(tmp_path):
    cfg = Config().replace_flat(dict(TINY, **{
        "train.store_sharded": True,
        "train.resident_fused_attention": False}))
    tr = ttr.Trainer(cfg, build_model(cfg), train_dir=str(tmp_path),
                     device="cpu")
    with pytest.raises(ValueError, match="store_sharded requires"):
        tr._prepare_resident(tds.load_dataset(cfg, "train"))
    tr.close()
