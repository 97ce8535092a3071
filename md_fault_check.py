"""Does ``chip_smoke.py`` phase 24(b) tell a wrong multi-device run from a
sound one? Runs its two-rank comparisons as it does (``md_dataset``,
``md_spawn``, ``md_fit``), then again with one fault planted in the ranks,
and prints what ``md_agree`` reads for each run against its sound
reference, and whether it passes the bf16 limits (MD_TOL_LOSS,
MD_GRAD_COS) and the float32 ones (MD_TOL_LOSS_F32, MD_GRAD_COS_F32):

- ``global_rows``: the sharded store's K4/K5 handed each question's global
  store row (wrapped into the shard's block) instead of row // n;
- ``grads_unsummed``: the gradient bucket not summed over the data group
  (the metrics still are): each rank trains on its own half;
- ``mean_of_means``: the step's weight not summed, so each rank's loss
  counts 1/n (a mean of the ranks' means; the data puts <unk> unevenly);
- ``tp_cotangent_unsummed``: the row product's input cotangent not summed
  over the model group (the tensor-parallel mesh).

A fault is a patch made in memory in the ranks only (``chip_smoke.md_rank``
replaced by :func:`faulty_rank`); the references and the sound runs are
the program as it is. On the card (the default) the runs are phase 24's,
at full width; ``--device cpu`` runs them at tiny widths in float32.
Prints one JSON object as its last line, and writes it to ``--out``::

    python md_fault_check.py [--device cpu] [--out readings.json]
"""

import argparse
import json
import os
import tempfile

import chip_smoke as cs

FAULTS = {  # fault: (case, its sound reference)
    "global_rows": ("sharded", "fed"),
    "grads_unsummed": ("replicated", "one"),
    "mean_of_means": ("replicated", "one"),
    "tp_cotangent_unsummed": ("tp", "replicated"),
}
# The CPU run's sizes (the ranks get them through md_spawn's settings).
CPU_SIZES = {"B_TRAIN": 32, "TRAIN_QUESTIONS": 512, "VAL_QUESTIONS": 64}
CPU_MODEL = {
    "data.vocab_size": 64, "data.num_answers": 16, "data.grid_h": 3,
    "data.grid_w": 3, "data.feature_dim": 16, "data.pool5_dim": 16,
    "data.max_question_len": 6, "model.word_dim": 8, "model.rnn_dim": 8,
    "model.fusion_dim": 16, "model.att_hidden": 8, "model.answer_dim": 8,
    "model.dtype": "float32"}


def plant(fault: str) -> None:
    """Patch ``fault`` into this process's trainer (a rank's)."""
    import torch
    from vqa_transfer_externaldata_torch.ops import row_shard
    from vqa_transfer_externaldata_torch.parallel import trainer as tr

    if fault == "global_rows":
        prepare = tr.Trainer._prepare_resident

        def prepare_global_rows(self, ds, drop_keys=()):
            data, make_batch, nbytes = prepare(self, ds, drop_keys)
            if not self.cfg.train.store_sharded:
                return data, make_batch, nbytes

            def wrong_rows(idx):
                batch = make_batch(idx)
                grid, _, *rest = batch["features"]
                batch["features"] = (grid, batch[ds.index_key]
                                     % grid.shape[0], *rest)
                return batch
            return data, wrong_rows, nbytes
        tr.Trainer._prepare_resident = prepare_global_rows
    elif fault == "grads_unsummed":
        def sum_metrics_only(self, grads, metrics):
            keys = sorted(metrics)
            vec = torch.stack([metrics[k] for k in keys])
            tr.all_reduce_sum(vec, self.mesh.data_group)
            return grads, dict(zip(keys, vec.unbind()))
        tr.Trainer._sum_over_data = sum_metrics_only
    elif fault == "mean_of_means":
        all_reduce_sum = tr.all_reduce_sum

        def weight_times_n(t, group):
            # The step's weight is the one 0-d tensor the data group sums.
            if t.dim() == 0:
                return t.mul_(torch.distributed.get_world_size(group))
            return all_reduce_sum(t, group)
        tr.all_reduce_sum = weight_times_n
    elif fault == "tp_cotangent_unsummed":
        row_shard._CopyToGroup.backward = staticmethod(
            lambda ctx, g: (g, None))
    else:
        raise ValueError(f"unknown fault {fault!r}")


def faulty_rank(*args) -> None:
    """``chip_smoke.md_rank`` with the fault named by ``MD_FAULT``."""
    plant(os.environ["MD_FAULT"])
    cs.md_rank(*args)


def readings(got: dict, want: dict) -> dict:
    """What ``chip_smoke.md_agree`` reads, without its check."""
    import torch

    loss_diff = max(abs(got["losses"][s] - want["losses"][s])
                    for s in want["losses"])
    delta = [torch.cat([(r["params"][n] - r["init"][n]).double().flatten()
                        for n in sorted(r["params"])]) for r in (got, want)]
    cos = torch.nn.functional.cosine_similarity(delta[0], delta[1], 0).item()
    return {"loss_max_abs_diff": loss_diff, "change_cos": cos,
            "passes": loss_diff <= cs.MD_TOL_LOSS and cos >= cs.MD_GRAD_COS,
            "passes_float32": (loss_diff <= cs.MD_TOL_LOSS_F32
                               and cos >= cs.MD_GRAD_COS_F32)}


def run(device: str) -> dict:
    import numpy as np
    import torch
    from vqa_transfer_externaldata_torch.data.datasets import load_dataset
    from vqa_transfer_externaldata_torch.parallel.trainer import (
        sharded_index_batches)

    if device == "cpu":
        for name, v in CPU_SIZES.items():
            setattr(cs, name, v)
        cs.MODEL_OVERRIDES = CPU_MODEL
        dev = torch.device("cpu")
    else:
        cs.check(torch.cuda.is_available(), "no CUDA device")
        dev = torch.device("cuda", 0)
        cs.phase_build({})
    out = {"limits": {"loss": cs.MD_TOL_LOSS, "cos": cs.MD_GRAD_COS},
           "limits_float32": {"loss": cs.MD_TOL_LOSS_F32,
                              "cos": cs.MD_GRAD_COS_F32}}
    with tempfile.TemporaryDirectory(prefix="md_fault_check_") as tmp:
        ref_cfg = cs.md_config("ref_data", tmp)
        ds = cs.md_dataset(ref_cfg, "replicated")
        ds_sh = cs.md_dataset(ref_cfg, "sharded")
        val = load_dataset(ref_cfg.replace_flat(
            {"data.synthetic_size": cs.VAL_QUESTIONS}), "val")
        owner = np.asarray(ds_sh.arrays[ds_sh.index_key]) % cs.MD_WORLD
        refs = {"one": cs.md_fit(cs.md_config("one", tmp), ds, val,
                                 device=dev),
                "fed": cs.md_fit(
                    cs.md_config("one_fed", tmp), ds_sh, val, device=dev,
                    index_batches=lambda bs, seed=0, **kw:
                    sharded_index_batches(owner, cs.MD_WORLD,
                                          bs // cs.MD_WORLD, seed))}

        def two_ranks(case, tag):
            root = os.path.join(tmp, tag)
            os.makedirs(root)
            return cs.md_spawn(case, str(dev), root)[0]

        sound = {case: two_ranks(case, f"sound_{case}")
                 for case in cs.MD_CASES}
        refs["replicated"] = sound["replicated"]
        for case, ref in (("replicated", "one"), ("sharded", "fed"),
                          ("tp", "replicated")):
            out[f"sound_{case}"] = readings(sound[case], refs[ref])
            print(f"sound {case}: {out[f'sound_{case}']}", flush=True)
        cs.md_rank = faulty_rank
        for fault, (case, ref) in FAULTS.items():
            os.environ["MD_FAULT"] = fault
            out[fault] = dict(readings(two_ranks(case, fault), refs[ref]),
                              case=case)
            print(f"fault {fault} ({case}): {out[fault]}", flush=True)
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--out", default="")
    args = ap.parse_args()
    out = run(args.device)
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(out, fh, indent=1)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
