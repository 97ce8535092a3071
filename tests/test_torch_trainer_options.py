"""Port parity: the Trainer's ``train.remat``, ``train.sort_batch_by_image``
and its profiler window (``train.profile_start`` / ``train.profile_steps``)
against the JAX package's Trainer and CLI tests.

Float32, on the CPU. remat changes memory, not math: on against off is
bit-equal in the port (dropout 0, and with dropout on: the recompute
replays the first pass's masks), and within rtol 1e-5 / atol 1e-6 of JAX's
remat run (``tests/test_trainer.py``'s bound). sort_batch_by_image permutes
each batch, so training differs by float summation order only: on against
off within JAX's own bound for that test (rtol 2e-4 / atol 2e-5), and the
sorted run within the same bound of JAX's sorted run, on JAX's fixture (an
8-image store, 96 questions, batch 32).
"""

import glob
import json
import os

import jax
import numpy as np
import pytest
import torch

from vqa_transfer_externaldata_tpu.config import Config as JaxConfig
from vqa_transfer_externaldata_tpu.data import datasets as jds
from vqa_transfer_externaldata_tpu.data import features as jfeat
from vqa_transfer_externaldata_tpu.models.zoo import build_model as jax_build
from vqa_transfer_externaldata_tpu.parallel.mesh import create_mesh
from vqa_transfer_externaldata_tpu.parallel.trainer import Trainer as JaxTrainer
from vqa_transfer_externaldata_torch.cli import train as train_cli
from vqa_transfer_externaldata_torch.config import Config
from vqa_transfer_externaldata_torch.data import datasets as tds
from vqa_transfer_externaldata_torch.data import features as tfeat
from vqa_transfer_externaldata_torch.models.zoo import build_model
from vqa_transfer_externaldata_torch.parallel.trainer import Trainer
from vqa_transfer_externaldata_torch.utils.convert import params_from_flax

torch.set_num_threads(2)  # xdist runs several workers on the same cores

TINY = {
    "data.synthetic": True, "data.synthetic_layout": "joined",
    "data.synthetic_size": 128, "data.vocab_size": 64,
    "data.num_answers": 16, "data.grid_h": 3, "data.grid_w": 3,
    "data.feature_dim": 16, "data.pool5_dim": 16,
    "data.max_question_len": 6, "model.word_dim": 8, "model.rnn_dim": 8,
    "model.fusion_dim": 16, "model.att_hidden": 8, "model.answer_dim": 8,
    "model.dtype": "float32", "model.dropout": 0.0,
    "train.batch_size": 16, "train.device_data_cache": True,
    "train.log_every": 2, "train.warmup_steps": 2,
    "train.learning_rate": 3e-3,
}
# tests/conftest.py's tiny_config, which JAX's sort test runs on.
JAX_TINY = {
    "data.synthetic": True, "data.synthetic_size": 256,
    "data.vocab_size": 128, "data.num_answers": 32,
    "data.grid_h": 4, "data.grid_w": 4, "data.feature_dim": 32,
    "data.pool5_dim": 32, "data.max_question_len": 8,
    "model.word_dim": 16, "model.rnn_dim": 16, "model.fusion_dim": 32,
    "model.att_hidden": 16, "model.answer_dim": 16,
    "model.dtype": "float32", "model.num_tasks": 4,
    "model.task_dim": 8, "model.num_candidates": 16,
    "model.dropout": 0.1,
    "train.batch_size": 32, "train.max_steps": 40,
    "train.log_every": 10, "train.eval_every": 10_000,
    "train.checkpoint_every": 20, "train.warmup_steps": 1,
    "train.learning_rate": 3e-3,
}


def _jax_trainer(flat, train_dir):
    jcfg = JaxConfig().replace_flat(flat)
    return jcfg, JaxTrainer(jcfg, jax_build(jcfg), mesh=create_mesh(
        jcfg, devices=jax.devices()[:1]), train_dir=str(train_dir))


def _port_fit(flat, train_dir, ds=None, params=None, max_steps=6):
    cfg = Config().replace_flat(flat)
    spec = build_model(cfg, generator=torch.Generator().manual_seed(0))
    tr = Trainer(cfg, spec, train_dir=str(train_dir), device="cpu")
    state = tr.fit_resident(tds.load_dataset(cfg, "train") if ds is None
                            else ds, tr.init_state(params),
                            max_steps=max_steps)
    tr.close()
    assert state.step == max_steps
    return spec.module.state_dict()


def _assert_close(got, want, **tol):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                   err_msg=k, **tol)


def test_remat_matches_no_remat_and_jax(tmp_path):
    """6 resident steps of ``vqa_attention`` (the gather-free path) with
    remat on: bit-equal to remat off, and within tolerance of JAX's remat
    run from the same bridged parameters (dropout 0)."""
    over = dict(TINY, **{"train.remat": True})
    jcfg, jtr = _jax_trainer(over, tmp_path / "jax")
    jtrain = jds.load_dataset(jcfg, "train")
    js = jtr.init_state(next(jtrain.batches(1, epochs=1, shuffle=False)))
    init = params_from_flax(jax.device_get(js.params))
    js = jtr.fit_resident(jtrain, js, max_steps=6)
    want = params_from_flax(jax.device_get(js.params))
    jtr.close()
    on = _port_fit(over, tmp_path / "on", params=init)
    off = _port_fit(TINY, tmp_path / "off", params=init)
    _assert_close(on, off, rtol=0, atol=0)
    _assert_close(on, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("model", ["vqa_attention", "vqa_baseline"])
def test_remat_with_dropout_is_bit_equal(tmp_path, model):
    """Dropout on (rate 0.5): the recompute in the backward pass replays the
    first pass's masks (DropoutTape), so remat on equals off bit for bit,
    and the dropout generator ends where it does without remat."""
    over = dict(TINY, **{"model.dropout": 0.5, "model.model": model})
    finals, rngs = [], []
    for on in (False, True):
        cfg = Config().replace_flat(dict(over, **{"train.remat": on}))
        spec = build_model(cfg, generator=torch.Generator().manual_seed(0))
        tr = Trainer(cfg, spec, train_dir=str(tmp_path / str(on)),
                     device="cpu")
        state = tr.fit_resident(tds.load_dataset(cfg, "train"),
                                tr.init_state(), max_steps=5)
        tr.close()
        finals.append(spec.module.state_dict())
        rngs.append(state.rng.get_state())
    _assert_close(finals[1], finals[0], rtol=0, atol=0)
    assert torch.equal(rngs[0], rngs[1])


def _sort_fixture(tmp_path, d):
    """JAX's fixture: 96 questions over an 8-image f16 store (heavy
    duplication, ~12 questions an image), seeded as in its test."""
    rng = np.random.default_rng(7)
    M, n = 8, 96
    path = str(tmp_path / "store.npz")
    np.savez(path,
             grid=rng.normal(size=(M, d["data.grid_h"], d["data.grid_w"],
                                   d["data.feature_dim"])).astype(np.float16),
             pool5=rng.normal(size=(M, d["data.pool5_dim"])).astype(
                 np.float32),
             image_ids=np.arange(M, dtype=np.int64))
    rows = {
        "q_ids": rng.integers(4, d["data.vocab_size"], size=(
            n, d["data.max_question_len"])).astype(np.int32),
        "answer_id": rng.integers(4, d["data.num_answers"],
                                  size=n).astype(np.int32),
        "image_index": rng.integers(0, M, size=n).astype(np.int32),
    }
    return path, rows


def test_sort_batch_by_image_is_training_invariant_and_matches_jax(tmp_path):
    """``tests/test_trainer.py``'s sort test (store_sharded False) on the
    port: 6 resident steps of ``vqa_attention`` with the staged batches
    sorted by store row against unsorted, and against JAX's sorted run from
    the same bridged parameters."""
    flat = dict(JAX_TINY, **{"model.model": "vqa_attention",
                             "model.dropout": 0.0, "model.dtype": "float32",
                             "train.batch_size": 32,
                             "train.device_data_cache": True,
                             "train.sort_batch_by_image": True})
    path, rows = _sort_fixture(tmp_path, flat)
    jcfg, jtr = _jax_trainer(flat, tmp_path / "jax")
    jds_ = jfeat.JoinedDataset(dict(rows), jfeat.FeatureStore(path),
                               index_key="image_index",
                               feature_keys=("features", "pool5"))
    js = jtr.init_state(next(jds_.batches(1, epochs=1, shuffle=False)))
    init = params_from_flax(jax.device_get(js.params))
    js = jtr.fit_resident(jds_, js, max_steps=6)
    want = params_from_flax(jax.device_get(js.params))
    jtr.close()

    def port_ds():
        return tfeat.JoinedDataset(dict(rows), tfeat.FeatureStore(path),
                                   index_key="image_index",
                                   feature_keys=("features", "pool5"))

    got = {sort: _port_fit(dict(flat, **{"train.sort_batch_by_image": sort}),
                           tmp_path / f"s{sort}", port_ds(), init)
           for sort in (False, True)}
    _assert_close(got[True], got[False], rtol=2e-4, atol=2e-5)
    _assert_close(got[True], want, rtol=2e-4, atol=2e-5)


def test_sort_batch_by_image_sorts_each_staged_batch(tmp_path, monkeypatch):
    """Each staged index batch is its unsorted batch ordered by store row
    with a stable sort: the same questions, their rows non-decreasing."""
    from vqa_transfer_externaldata_torch.parallel import trainer as tt

    flat = dict(JAX_TINY, **{"model.model": "vqa_attention",
                             "model.dtype": "float32",
                             "train.device_data_cache": True})
    path, rows = _sort_fixture(tmp_path, flat)
    staged = {}
    real = torch.from_numpy
    for sort in (False, True):
        seen = staged[sort] = []

        def spy(a, seen=seen):
            if a.dtype == np.int32 and a.shape[1:] == (32,):
                seen.append(a.copy())
            return real(a)

        monkeypatch.setattr(tt.torch, "from_numpy", spy)
        _port_fit(dict(flat, **{"train.sort_batch_by_image": sort}),
                  tmp_path / f"s{sort}", tfeat.JoinedDataset(
                      dict(rows), tfeat.FeatureStore(path)), max_steps=3)
        monkeypatch.undo()
    plain, ordered = staged[False][0], staged[True][0]
    image = rows["image_index"]
    for a, b in zip(plain, ordered):
        np.testing.assert_array_equal(b, a[np.argsort(image[a],
                                                      kind="stable")])
        assert (np.diff(image[b]) >= 0).all()


def _cli(tmp_path, name, *extra):
    argv = ["--device", "cpu", "--train.train_dir", str(tmp_path / name),
            "--model.model", "vqa_baseline"]
    for k, v in TINY.items():
        argv += [f"--{k}", str(v).lower() if isinstance(v, bool) else str(v)]
    train_cli.main(argv + list(extra))
    traces = glob.glob(str(tmp_path / name / "profile" / "*.trace.json.gz"))
    windows = {}
    for w in glob.glob(str(tmp_path / name / "profile" / "*.window.json")):
        with open(w) as fh:
            windows[os.path.basename(w)] = json.load(fh)
    return traces, windows


@pytest.mark.parametrize("resident", ["true", "false"])
def test_profile_flag_writes_trace(tmp_path, resident):
    """``tests/test_cli.py``'s profile test on the port, on both loops: a
    window of steps 2..4 writes a gzip'd Chrome trace and its window file
    (the steps it spans; no CUDA-event time on the CPU)."""
    traces, windows = _cli(tmp_path, "run", "--train.max_steps", "6",
                           "--train.profile_start", "2",
                           "--train.profile_steps", "2",
                           "--train.device_data_cache", resident)
    assert [os.path.basename(t) for t in traces] == [
        "trace_2_4.pt.trace.json.gz"]
    assert windows == {"trace_2_4.window.json": {
        "first_step": 2, "last_step": 4, "steps": 2,
        "cuda_event_ms": None}}


@pytest.mark.parametrize("resident", ["true", "false"])
def test_profile_start_between_dispatch_boundaries_still_traces(tmp_path,
                                                                resident):
    """k = 4: the loop's call boundaries are steps 0, 4, 8, so a
    profile_start of 2 is never hit exactly; the window opens at 4 and
    closes at the first boundary at or past its end, 2 + 5 = 7: step 8."""
    traces, windows = _cli(tmp_path, "k4", "--train.max_steps", "12",
                           "--train.steps_per_call", "4",
                           "--train.profile_start", "2",
                           "--train.profile_steps", "5",
                           "--train.device_data_cache", resident)
    assert [os.path.basename(t) for t in traces] == [
        "trace_4_8.pt.trace.json.gz"]
    assert windows["trace_4_8.window.json"]["steps"] == 4


def test_profile_window_past_max_steps_still_writes_trace(tmp_path):
    """profile_start + profile_steps past max_steps: the window is closed
    and written when training ends."""
    traces, windows = _cli(tmp_path, "trunc", "--train.max_steps", "4",
                           "--train.profile_start", "2",
                           "--train.profile_steps", "100")
    assert [os.path.basename(t) for t in traces] == [
        "trace_2_4.pt.trace.json.gz"]
    assert windows["trace_2_4.window.json"]["steps"] == 2


@pytest.mark.parametrize("resident", ["true", "false"])
def test_train_cli_passes_the_options_to_both_loops(tmp_path, monkeypatch,
                                                    resident):
    """``cli.train`` takes the options as config fields (no flag of its
    own) and they reach the Trainer on the resident and the streamed
    branch alike."""
    seen = []
    for loop in ("fit", "fit_resident"):
        real = getattr(Trainer, loop)

        def spy(self, *a, _real=real, _loop=loop, **kw):
            seen.append((_loop, self.cfg.train))
            return _real(self, *a, **kw)

        monkeypatch.setattr(Trainer, loop, spy)
    _cli(tmp_path, "opts", "--train.max_steps", "4",
         "--train.device_data_cache", resident,
         "--train.steps_per_call", "2", "--train.remat", "true",
         "--train.sort_batch_by_image", "true",
         "--train.profile_start", "2", "--train.profile_steps", "2")
    [(loop, t)] = seen
    assert loop == ("fit_resident" if resident == "true" else "fit")
    assert (t.steps_per_call, t.remat, t.sort_batch_by_image,
            t.profile_start, t.profile_steps) == (2, True, True, 2, 2)
