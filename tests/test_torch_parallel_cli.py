"""Data parallelism of the port around the steps: two gloo processes on the
CPU (tests/_torch_mp_worker.py, suite ``cli``), launched once for the module.

Held on every rank: a sharded ``evaluate_benchmarks`` over an LMDB of nine
words (shards of five and four) returns the counters of one process's run
over all nine (the normalised edit distance, a sum of fractions, to 1e-12); ``MetricLogger`` sums counts and totals over the ranks and
``TextAccuracy`` takes the largest inference time; the ``mesh`` keys are
refused as the JAX package's ``data_mesh`` / ``pretrain_mesh`` would have
them (a ``num_devices`` other than the world size, a ``model_parallel``
that does not divide it), and a checkpoint's generator states of another world
size are refused; ``cli.train`` at world size 2 writes one checkpoint
directory, from rank 0, whose payload holds both ranks' generator states,
and a second run resumes from it; ``cli.collective_audit`` prints one JSON
line whose gradient all-reduce carries 4 bytes per student parameter, once
a step.
"""

import json
import os

import pytest
import torch

import _torch_mp_worker as W


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out_dir = str(tmp_path_factory.mktemp("parallel_cli"))
    outs = W.wait_for(W.launch_workers("cli", out_dir))
    results = []
    for r in range(W.WORLD):
        with open(os.path.join(out_dir, f"cli_rank{r}.json")) as f:
            results.append(json.load(f))
    return {"dir": out_dir, "results": results, "outs": outs}


@pytest.mark.parametrize("rank", range(W.WORLD))
def test_sharded_evaluation_counts_every_word_once(ranks, rank):
    ev = ranks["results"][rank]["eval"]
    sharded, full = ev["sharded"], ev["full"]
    assert full["words"] == W.EVAL_WORDS
    for key in ("ccr", "cwr", "ted", "words"):  # counts and their ratios: exact
        assert sharded[key] == full[key], key
    for key in ("ned", "ted/w"):  # sums of fractions, added in another order
        assert sharded[key] == pytest.approx(full[key], rel=1e-12), key
    assert ev["sharded_acc"] == ev["full_acc"]


@pytest.mark.parametrize("rank", range(W.WORLD))
def test_meters_and_accuracy_time_sync_over_the_ranks(ranks, rank):
    m = ranks["results"][rank]["meters"]
    # rank 0 logged 1, 2; rank 1 logged 2, 3
    assert m["count"] == 4 and m["total"] == 8.0 and m["global_avg"] == 2.0
    assert m["time"] == 2.0


@pytest.mark.parametrize("case", ["fewer_devices", "more_devices", "model_parallel",
                                  "other_world_size", "accepted"])
def test_mesh_keys_and_world_size_are_refused(ranks, case):
    assert all(r["refusals"][case] for r in ranks["results"])


def test_train_cli_writes_one_checkpoint_directory_from_rank_0_and_resumes(ranks):
    run_dir = os.path.join(ranks["dir"], "cli_train")
    assert os.listdir(os.path.join(run_dir, "saved_models")) == ["smoke_pretrain"]
    ckpt_dir = os.path.join(run_dir, "saved_models", "smoke_pretrain")
    assert sorted(os.listdir(ckpt_dir)) == ["ckpt_00000002.pt", "ckpt_00000004.pt"]
    payload = torch.load(os.path.join(ckpt_dir, "ckpt_00000004.pt"), weights_only=True)
    assert payload["world_size"] == W.WORLD and len(payload["generators"]) == W.WORLD
    assert not torch.equal(payload["generators"][0][1], payload["generators"][1][1])
    for r in ranks["results"]:
        first, second = r["train_cli"]["first"], r["train_cli"]["second"]
        assert first["iteration"] == first["checkpoint"] == 2
        assert second["iteration"] == second["checkpoint"] == 4
        assert r["train_cli"]["resumed"]
    # the losses and the schedule are global; the flood rounds are each
    # rank's own (its share of the masks), so they may differ
    last = [dict(r["train_cli"]["second"]["last"]) for r in ranks["results"]]
    rounds = [m.pop("cluster_rounds") for m in last]
    assert all(n >= 1 for n in rounds)
    assert last[0] == last[1]


def test_collective_audit_prints_the_gradient_all_reduce(ranks):
    r0, r1 = ranks["results"]
    lines = r0["audit_printed"].strip().splitlines()
    assert len(lines) == 1 and r1["audit_printed"] == ""
    printed = json.loads(lines[0])
    assert printed == r0["audit"] and printed["world"] == W.WORLD
    grads = printed["collectives"]["all_reduce:gradients"]
    assert grads == {"calls_per_step": 1.0, "bytes_per_step": 4.0 * printed["student_parameters"]}
    for what in ("all_reduce:center", "all_reduce:batchnorm", "all_reduce:batchnorm_backward",
                 "all_reduce:dino_denominator", "all_reduce:losses"):
        assert printed["collectives"][what]["calls_per_step"] >= 1, what


def test_shard_batch_takes_each_process_rows():
    """The counterparts of the JAX package's ``shard_batch`` /
    ``shard_stacked_batch``: process ``i`` of ``n`` holds rows
    [i B / n, (i + 1) B / n) of the global batch (dim 0, or dim 1 of a
    (K, B, ...) stack), tensors and arrays in any nesting; a batch that does
    not split evenly is refused."""
    import numpy as np

    from ccd_tpu_torch.parallel.mesh import shard_batch, shard_stacked_batch
    x, stacked = torch.arange(12).reshape(6, 2), np.arange(24).reshape(2, 6, 2)
    a, (b,) = shard_batch((x, [x.numpy()]), 1, 3)
    assert torch.equal(a, x[2:4]) and np.array_equal(b, x.numpy()[2:4])
    assert np.array_equal(shard_stacked_batch({"k": stacked}, 2, 3)["k"], stacked[:, 4:6])
    with pytest.raises(ValueError, match="does not split over 4"):
        shard_batch(x, 0, 4)
