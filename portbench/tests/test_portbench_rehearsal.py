"""The runner on the CPU at each configuration's rehearsal sizes: a result
line with every key a run prints, ``correct`` true on the program, and false
with the timed path broken underneath or the lower-precision control in
the program's place."""

import pytest

from portbench import harness
from portbench.tests._run import rehearse, run

SPEC = harness.load_spec()
CELLS = [w["name"] for w in SPEC["workloads"]]
TRAINING = [w for w in CELLS if not w.startswith("eval")]


@pytest.mark.parametrize("workload", CELLS)
def test_result_line(workload):
    rc, last, err = rehearse(workload)
    assert rc == 0, err[-3000:]
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(last)
    assert last["correct"] is True and last["failed"] == 0 and last["attempted"] > 0
    wanted = {m["name"] for m in harness.metric_names(SPEC, workload, "end_to_end")}
    assert set(last["metrics"]) == wanted
    assert all(set(v) == {"value", "unit"} for v in last["metrics"].values())
    assert set(last["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    assert list(last)[-1] == "checked" and last["checked"]
    assert err.strip().splitlines()[-1].split()[0] == list(last["checked"])[-1]


@pytest.mark.parametrize("workload,fault", [(w, f) for w in TRAINING
                                            for f in ("unchanged", "half_batch")]
                         + [("pretrain-vit_small-b256", "teacher_unchanged"),
                            ("eval-ard-b1024", "token")])
def test_faults_come_out_not_correct(workload, fault):
    rc, last, err = rehearse(workload, "--fault", fault)
    assert rc == 0, err[-3000:]
    assert last["correct"] is False


@pytest.mark.parametrize("workload", CELLS)
def test_control_comes_out_not_correct(workload):
    rc, last, err = rehearse(workload, "--control")
    assert rc == 0, err[-3000:]
    assert last["correct"] is False


def test_no_card_no_result():
    rc, last, err = run("--workload", CELLS[0], "--seed", "1", "--seconds", "1")
    import torch
    if torch.cuda.is_available():
        pytest.skip("this process sees a card")
    assert rc != 0 and last is None and "CUDA" in err


def test_traced_rehearsal_refused():
    rc, last, _ = rehearse(CELLS[0], "--trace", "1")
    assert rc != 0 and last is None


@pytest.mark.card
@pytest.mark.parametrize("workload", CELLS)
def test_cell_on_the_card(card, workload):
    rc, last, err = run("--workload", workload, "--seed", "3000000023", "--seconds", "5",
                        "--trace", "1", timeout=900)
    assert rc == 0, err[-3000:]
    assert last["correct"] is True and last["device"]["platform"] == "gpu"
    assert last["device"]["busy_s"] > 0
