"""Worker process of the port's data-parallel tests (tests/test_torch_parallel*.py).

One of ``world`` processes joined in a ``torch.distributed`` gloo group on
the CPU through the port's own ``parallel.mesh.init_distributed`` (the
``torchrun`` environment: ``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``,
``MASTER_PORT``, set by the test). It imports ``torch`` and
``ccd_tpu_torch`` only; the test process computes the JAX side and hands
weights and inputs over as ``.npz``. Each suite writes one result file per
rank that the test reads:

* ``steps``: the pretraining and finetune steps on this rank's share of a
  global batch (``steps_inputs.npz``), their losses and final states;
* ``cli``: sharded ``evaluate_benchmarks``, the meters' and the accuracy's
  synchronisation, the ``mesh`` refusals, a resume at another world size,
  ``cli.train`` twice (a run and its resume) and ``cli.collective_audit``;
* ``tp``: tensor parallelism (``mesh.model_parallel`` = TP_MP) at world 4
  (2 data ranks x 2 model ranks) or 2 (1 x 2): the refusals, the steps on
  this data rank's share of the global batch (``tp_inputs.npz`` in the
  parent of ``out_dir``), the gathered checkpoint, a resume from the test
  process's one-process checkpoint (world 2), a lars step, a BatchNorm
  DINO head, and ``cli.collective_audit`` (world 4).

The test process imports this module too, for the constants and for
:func:`pretrain_run` / :func:`finetune_run` / :func:`tp_state` /
:func:`tp_steps` / :func:`bn_head_run`, which it runs without a group on the
whole batch (the 1-rank reference).

Invoked as: python _torch_mp_worker.py <suite> <out_dir>
"""

import contextlib
import io
import json
import logging
import os
import socket
import subprocess
import sys
import threading
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMOKE_PRETRAIN = os.path.join(REPO, "ccd_tpu_torch", "configs", "smoke_pretrain.yaml")

# ---- the steps (vit_micro, fp32, drop path and dropout off)
N_STEPS, GLOBAL_BATCH, OUT_DIM = 3, 4, 256
PRETRAIN_SCHEDULE = dict(base_lr=5e-4, min_lr=1e-6, total_iters=100, warmup_iters=2,
                         weight_decay=0.04, weight_decay_end=0.4, momentum_teacher=0.99,
                         clip_grad=3.0, freeze_last_layer=0, global_batch=GLOBAL_BATCH,
                         imgnet_based=1000, gt_mask_epochs=30)
TEACHER_TEMPS = (0.04, 0.07, 3, 10)      # teacher_temp_schedule's arguments
MICRO_DECODER = dict(decoder_n_layers=2, decoder_d_embedding=64, decoder_n_head=2,
                     decoder_d_k=32, decoder_d_v=32, decoder_d_model=64,
                     decoder_d_inner=64, max_seq_len=6)
FINETUNE_SCHEDULE = dict(base_lr=1e-3, min_lr=1e-5, total_iters=20, warmup_iters=2,
                         weight_decay=0.05, clip_grad=0.5)
EVAL_WORDS = 9                           # odd: the two shards differ in size
WORLD = 2
WORKER_TIMEOUT_S = 300
TP_MP = 2                                # the model axis of the ``tp`` suite
BN_HEAD = dict(in_dim=64, out_dim=OUT_DIM, use_bn=True, norm_last_layer=False,
               hidden_dim=32, bottleneck_dim=16)   # the BatchNorm DINO head's widths
MP1_CHECKPOINT = "tp_mp1_ckpt.pt"        # the test process's, in the parent of out_dir


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch_workers(suite: str, out_dir: str, world: int = WORLD):
    """``world`` worker processes of ``suite`` in one gloo group over
    localhost, as ``torchrun`` on one node would start them."""
    port = free_port()
    env = dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
               WORLD_SIZE=str(world), LOCAL_WORLD_SIZE=str(world), OMP_NUM_THREADS="1")
    return [subprocess.Popen([sys.executable, os.path.abspath(__file__), suite, out_dir],
                             env=dict(env, RANK=str(r), LOCAL_RANK=str(r)),
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(world)]


def wait_for(procs):
    """Each worker's output; every worker killed if one fails or is late."""
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=WORKER_TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {r} exited with {p.returncode}:\n{out[-4000:]}"
    return outs


def _orphan_watchdog():
    """Exit if the launching test process dies, so that a worker left alone
    does not hold the group's port or wait at a collective for ever."""
    def watch():
        while True:
            if os.getppid() == 1:
                os._exit(3)
            time.sleep(2.0)

    threading.Thread(target=watch, daemon=True).start()


def pretrain_run(arrays, group=None, process=0, count=1):
    """N_STEPS port pretraining steps from the handed-over state on process
    ``process``'s share of the global batch; (losses, student, teacher, centre)."""
    import torch

    from ccd_tpu_torch.losses import teacher_temp_schedule
    from ccd_tpu_torch.models.pretrain import CCDPretrainModel
    from ccd_tpu_torch.parallel.mesh import shard_batch
    from ccd_tpu_torch.training.pretrain_step import init_pretrain_state, make_pretrain_step

    student = CCDPretrainModel(arch="vit_micro", out_dim=OUT_DIM, with_seg_head=True,
                               norm_last_layer=False, drop_path_rate=0.0)
    teacher = CCDPretrainModel(arch="vit_micro", out_dim=OUT_DIM, with_seg_head=False)
    state = init_pretrain_state(student, teacher, process=process)
    for prefix, module in (("student.", student), ("teacher.", teacher)):
        module.load_state_dict({k[len(prefix):]: torch.from_numpy(v) for k, v in arrays.items()
                                if k.startswith(prefix)}, strict=True)
    state.center = torch.from_numpy(arrays["center"].copy())
    step = make_pretrain_step(teacher_temps=teacher_temp_schedule(*TEACHER_TEMPS),
                              use_fused_ce=True, group=group, **PRETRAIN_SCHEDULE)
    losses = []
    for i in range(N_STEPS):
        images, masks, theta = shard_batch(
            tuple(torch.from_numpy(arrays[f"pretrain_{k}_{i}"])
                  for k in ("images", "masks", "theta")), process, count)
        state, m = step(state, images, masks, theta)
        losses.append([float(m[k]) for k in ("loss", "mask_loss", "dino_loss")])
    return (np.asarray(losses), {k: v.numpy().copy() for k, v in student.state_dict().items()},
            {k: v.numpy().copy() for k, v in teacher.state_dict().items()},
            state.center.numpy().copy())


def finetune_run(arrays, group=None, process=0, count=1):
    """N_STEPS port finetune steps from the handed-over weights on process
    ``process``'s share of the global batch; (losses, recognizer state)."""
    import torch

    from ccd_tpu_torch.models import CCDRecognizer
    from ccd_tpu_torch.parallel.mesh import shard_batch
    from ccd_tpu_torch.training.finetune_step import init_finetune_state, make_finetune_step

    model = CCDRecognizer(arch="vit_micro", drop_path_rate=0.0, decoder_dropout=0.0,
                          encoder_drop=0.0, **MICRO_DECODER)
    model.load_state_dict({k[len("net."):]: torch.from_numpy(v) for k, v in arrays.items()
                           if k.startswith("net.")}, strict=True)
    state = init_finetune_state(model, process=process)
    step = make_finetune_step(group=group, **FINETUNE_SCHEDULE)
    losses = []
    for i in range(N_STEPS):
        images, targets = shard_batch((torch.from_numpy(arrays[f"finetune_images_{i}"]),
                                       torch.from_numpy(arrays[f"finetune_targets_{i}"])),
                                      process, count)
        state, m = step(state, images, targets)
        losses.append(float(m["loss"]))
    return np.asarray(losses), {k: v.numpy().copy() for k, v in model.state_dict().items()}


def tp_state(arrays, layout=None, optimizer="adamw"):
    """The handed-over pretraining state (as :func:`pretrain_run` builds it),
    sharded over ``layout``'s model axis."""
    import torch

    from ccd_tpu_torch.models.pretrain import CCDPretrainModel
    from ccd_tpu_torch.parallel.mesh import Layout
    from ccd_tpu_torch.training.pretrain_step import init_pretrain_state, shard_pretrain_state

    layout = Layout.of(layout)
    student = CCDPretrainModel(arch="vit_micro", out_dim=OUT_DIM, with_seg_head=True,
                               norm_last_layer=False, drop_path_rate=0.0)
    teacher = CCDPretrainModel(arch="vit_micro", out_dim=OUT_DIM, with_seg_head=False)
    state = init_pretrain_state(student, teacher, optimizer=optimizer,
                                process=layout.data_index)
    for prefix, module in (("student.", student), ("teacher.", teacher)):
        module.load_state_dict({k[len(prefix):]: torch.from_numpy(v) for k, v in arrays.items()
                                if k.startswith(prefix)}, strict=True)
    state.center = torch.from_numpy(arrays["center"].copy())
    return shard_pretrain_state(state, layout)


def tp_steps(state, arrays, layout=None, steps=range(N_STEPS), **schedule):
    """Port pretraining steps under ``layout`` on the global batches
    ``steps`` (this data rank's share); the (global) losses, one row a step."""
    import torch

    from ccd_tpu_torch.losses import teacher_temp_schedule
    from ccd_tpu_torch.parallel.mesh import Layout, shard_batch
    from ccd_tpu_torch.training.pretrain_step import make_pretrain_step

    layout = Layout.of(layout)
    step = make_pretrain_step(teacher_temps=teacher_temp_schedule(*TEACHER_TEMPS), group=layout,
                              **dict(PRETRAIN_SCHEDULE, **schedule))
    losses = []
    for i in steps:
        images, masks, theta = shard_batch(
            tuple(torch.from_numpy(arrays[f"pretrain_{k}_{i}"])
                  for k in ("images", "masks", "theta")), layout.data_index, layout.data_size)
        state, m = step(state, images, masks, theta)
        losses.append([float(m[k]) for k in ("loss", "mask_loss", "dino_loss")])
    return np.asarray(losses)


def bn_head_run(layout=None):
    """One forward and backward of a ``DINOHead(use_bn=True)`` (BN_HEAD) from
    seeded weights on seeded char vectors of GLOBAL_BATCH samples, this data
    rank's share, through the DINO CE, its gradients reduced as the step
    reduces them: (global loss, {name: whole gradient}, {name: running
    statistic})."""
    import torch

    from ccd_tpu_torch.losses import dino_char_loss
    from ccd_tpu_torch.models.heads import DINOHead
    from ccd_tpu_torch.models.layers import set_batchnorm_group
    from ccd_tpu_torch.parallel.mesh import Layout, all_reduce_sum, gather_rows, shard_rows
    from ccd_tpu_torch.training.pretrain_step import _reduce_gradients

    layout = Layout.of(layout)
    head = DINOHead(**BN_HEAD)
    head.reset_parameters(torch.Generator().manual_seed(11))
    if layout.model is not None:
        head.shard_last_layer(layout.model_index, layout.model_size, layout.model)
    set_batchnorm_group(head, layout.data)
    gen = torch.Generator().manual_seed(12)
    b, t, k = GLOBAL_BATCH, 26, OUT_DIM
    x = torch.randn(2, b, t, BN_HEAD["in_dim"], generator=gen)
    teacher = torch.randn(2, b, t, k, generator=gen)
    center = 0.1 * torch.randn(1, k, generator=gen)
    valid = torch.rand(b, t, generator=gen) < 0.6
    mine = lambda v, dim: shard_rows(v, layout.data_index, layout.data_size, dim)
    cols = lambda v: shard_rows(v, layout.model_index, layout.model_size, v.ndim - 1)
    logits = head(mine(x, 1).flatten(0, 1))
    loss = dino_char_loss(logits, cols(mine(teacher, 1).flatten(0, 1)), mine(valid, 0),
                          cols(center), 0.04, 0.1, group=layout.data, model_group=layout.model)
    named = dict(head.named_parameters())
    grads = torch.autograd.grad(loss, list(named.values()))
    sharded = [layout.model is not None and n.startswith("last_layer.") for n in named]
    grads = _reduce_gradients(list(grads), sharded, layout)
    grads = {n: gather_rows(g, layout.model, "test") if f else g
             for n, g, f in zip(named, grads, sharded)}
    stats = {n: v.clone() for n, v in head.state_dict().items() if "running" in n}
    return float(all_reduce_sum(loss.detach().reshape(1), layout.data, "test")[0]), grads, stats


def _tp_suite(out_dir, group, me, n):
    import contextlib
    import io

    import torch

    from ccd_tpu_torch.checkpoints.torch_io import generator_payload, restore_generators
    from ccd_tpu_torch.cli import collective_audit
    from ccd_tpu_torch.losses import teacher_temp_schedule
    from ccd_tpu_torch.models.heads import DINOHead
    from ccd_tpu_torch.parallel.mesh import (collective_counts_by_group, pretrain_mesh,
                                             reset_collective_counts, world)
    from ccd_tpu_torch.training.pretrain_step import (make_pretrain_step,
                                                      pretrain_state_payload,
                                                      restore_pretrain_state)

    parent = os.path.dirname(out_dir)
    arrays = dict(np.load(os.path.join(parent, "tp_inputs.npz")))
    out = {"rank": me}
    # ---- refusals before any group is made: JAX's divisor, and a model group
    # across nodes
    refusals = {"divisor": _refused(lambda: pretrain_mesh(None, 3), ValueError,
                                    f"model_parallel=3 must divide device count {n}")}
    os.environ["LOCAL_WORLD_SIZE"] = "1"
    refusals["span_hosts"] = _refused(lambda: pretrain_mesh(None, TP_MP), ValueError,
                                      "would span hosts")
    os.environ["LOCAL_WORLD_SIZE"] = str(n)
    layout = pretrain_mesh(None, TP_MP)
    out["layout"] = [layout.data_index, layout.model_index, layout.data_size,
                     layout.model_size, world(layout.data), world(layout.model)]
    refusals["out_dim"] = _refused(
        lambda: DINOHead(8, OUT_DIM - 1).shard_last_layer(layout.model_index, TP_MP,
                                                          layout.model),
        ValueError, "last dim not divisible")
    refusals["fused_ce"] = _refused(
        lambda: make_pretrain_step(teacher_temps=teacher_temp_schedule(*TEACHER_TEMPS),
                                   use_fused_ce=True, group=layout, **PRETRAIN_SCHEDULE),
        ValueError, "use_fused_ce=True")
    gen = [torch.Generator().manual_seed(me)]
    other = {"world_size": layout.data_size + 1,
             "generators": [[gen[0].get_state()]] * (layout.data_size + 1)}
    refusals["other_data_ranks"] = _refused(lambda: restore_generators(gen, other, layout.data),
                                            ValueError, "another world size")
    # as many data ranks (fewer than the processes): accepted
    restore_generators(gen, generator_payload(gen, layout.data), layout.data)
    out["refusals"] = refusals

    # ---- three steps, the gathered checkpoint and this rank's own tensors
    state = tp_state(arrays, layout)
    reset_collective_counts()
    losses = tp_steps(state, arrays, layout)
    out["groups"] = collective_counts_by_group()
    payload = pretrain_state_payload(state, layout)
    if me == 0:
        torch.save(payload, os.path.join(out_dir, "tp_ckpt.pt"))
    local = {**{f"student.{k}": v for k, v in state.student.state_dict().items()},
             **{f"teacher.{k}": v for k, v in state.teacher.state_dict().items()},
             "center": state.center}
    arrays_out = {"losses": losses, **{k: v.numpy() for k, v in local.items()}}
    if layout.data_size == 1:
        # ---- the next step from here, and from the one-process checkpoint
        arrays_out["next_loss"] = tp_steps(state, arrays, layout, steps=[N_STEPS])
        path = os.path.join(parent, MP1_CHECKPOINT)
        deadline = time.time() + WORKER_TIMEOUT_S
        while not os.path.exists(path) and time.time() < deadline:
            time.sleep(0.2)
        resumed = tp_state(arrays, layout)
        restore_pretrain_state(resumed, torch.load(path, weights_only=True), layout)
        arrays_out["resumed_next_loss"] = tp_steps(resumed, arrays, layout, steps=[N_STEPS])
    # ---- one lars step (warm-up off: the learning rate is not 0)
    lars = tp_state(arrays, layout, "lars")
    arrays_out["lars_loss"] = tp_steps(lars, arrays, layout, steps=[0], warmup_iters=0)
    lars_payload = pretrain_state_payload(lars, layout)
    if me == 0:
        torch.save({"trace": lars_payload["opt_state"]["trace"],
                    "student": lars_payload["student"], "center": lars_payload["center"]},
                   os.path.join(out_dir, "tp_lars.pt"))
    # ---- the BatchNorm head
    bn_loss, bn_grads, bn_stats = bn_head_run(layout)
    if me == 0:
        torch.save({"loss": bn_loss, "grads": bn_grads, "stats": bn_stats},
                   os.path.join(out_dir, "tp_bn_head.pt"))
    np.savez(os.path.join(out_dir, f"tp_rank{me}.npz"), **arrays_out)
    if layout.data_size > 1:
        # ---- the collective audit at (data, model) = (2, 2) and at
        # model_parallel 1 over the same world (rank 0 prints)
        for mp in (TP_MP, 1):
            printed = io.StringIO()
            with contextlib.redirect_stdout(printed):
                audit = collective_audit.main(["-c", SMOKE_PRETRAIN, "--arch", "vit_micro",
                                               "--batch", "2", "--steps", "1",
                                               "--model_parallel", str(mp), "--device", "cpu"])
            out[f"audit_mp{mp}"], out[f"audit_mp{mp}_printed"] = audit, printed.getvalue()
    with open(os.path.join(out_dir, f"tp_rank{me}.json"), "w") as f:
        json.dump(out, f, default=float)


def _steps_suite(out_dir, group, me, n):
    arrays = dict(np.load(os.path.join(out_dir, "steps_inputs.npz")))
    losses, student, teacher, center = pretrain_run(arrays, group, me, n)
    ft_losses, net = finetune_run(arrays, group, me, n)
    np.savez(os.path.join(out_dir, f"steps_rank{me}.npz"), pretrain_losses=losses,
             center=center, finetune_losses=ft_losses,
             **{f"student.{k}": v for k, v in student.items()},
             **{f"teacher.{k}": v for k, v in teacher.items()},
             **{f"net.{k}": v for k, v in net.items()})


def _refused(fn, error, words):
    try:
        fn()
    except error as e:
        return words in str(e)
    return False


def _cli_suite(out_dir, group, me, n):
    import torch

    import ccd_tpu_torch.utils.logging as port_logging
    from ccd_tpu_torch.cli import collective_audit, train
    from ccd_tpu_torch.checkpoints.torch_io import generator_payload, restore_generators
    from ccd_tpu_torch.data.synthetic import write_synthetic_lmdb
    from ccd_tpu_torch.evaluation.accuracy import TextAccuracy
    from ccd_tpu_torch.evaluation.runner import evaluate_benchmarks
    from ccd_tpu_torch.models import CCDRecognizer
    from ccd_tpu_torch.parallel.mesh import data_mesh, pretrain_mesh
    from ccd_tpu_torch.utils import MetricLogger

    out = {"rank": me}
    # ---- sharded evaluation of an odd number of words, against one process's
    root = os.path.join(out_dir, "evaluation", "SYNTH")
    if me == 0:
        write_synthetic_lmdb(root, EVAL_WORDS, seed=4)
    torch.distributed.barrier(group)
    model = CCDRecognizer(arch="vit_micro", **MICRO_DECODER)
    model.reset_parameters(torch.Generator().manual_seed(7))
    args = dict(batch_size=1, max_seq_len=MICRO_DECODER["max_seq_len"], num_workers=1)
    sharded, sharded_acc = evaluate_benchmarks(model, [root], **args)
    full, full_acc = evaluate_benchmarks(model, [root], process_index=0, process_count=1, **args)
    out["eval"] = {"sharded": sharded[0], "full": full[0], "sharded_acc": sharded_acc,
                   "full_acc": full_acc}
    # ---- meters and the accuracy's inference time
    meters = MetricLogger()
    for v in (me + 1.0, me + 2.0):
        meters.update(loss=v)
    meters.synchronize_between_processes()
    acc = TextAccuracy()
    acc.inference_time = float(me + 1)
    acc.synchronize_between_processes()
    out["meters"] = {"count": meters.loss.count, "total": meters.loss.total,
                     "global_avg": meters.loss.global_avg, "time": acc.inference_time}
    # ---- the mesh keys and a resume at another world size
    gen = [torch.Generator().manual_seed(me)]
    out["refusals"] = {
        "fewer_devices": _refused(lambda: data_mesh(n - 1), ValueError, "processes would have"),
        "more_devices": _refused(lambda: data_mesh(n + 1), ValueError,
                                 f"num_devices={n + 1} > available {n}"),
        "model_parallel": _refused(lambda: pretrain_mesh(None, 3), ValueError,
                                   f"model_parallel=3 must divide device count {n}"),
        "other_world_size": _refused(
            lambda: restore_generators(gen, generator_payload(gen), group), ValueError,
            "another world size"),
        "accepted": data_mesh(n) is group and pretrain_mesh(None, 1).data is group
        and pretrain_mesh(n, None).world is group}
    # ---- the train CLI: a run, then its resume, both ranks in one directory
    port_logging.summary_writer = lambda name: None  # TensorBoard is tested elsewhere
    run_dir = os.path.join(out_dir, "cli_train")
    os.makedirs(run_dir, exist_ok=True)
    os.chdir(run_dir)
    records = []
    handler = logging.Handler()
    handler.emit = lambda record: records.append(record.getMessage())
    logging.getLogger().addHandler(handler)
    logging.getLogger().setLevel(logging.INFO)
    argv = ["-c", SMOKE_PRETRAIN, "--arch", "vit_micro", "--batch_size_per_gpu", "2",
            "--synthetic", "8", "--epochs", "4", "--device", "cpu"]
    first = train.main(argv + ["--max_iters", "2"])
    second = train.main(argv + ["--max_iters", "4"])
    logging.getLogger().removeHandler(handler)
    out["train_cli"] = {"first": first, "second": second,
                        "resumed": any("resuming from checkpoint step 2" in r for r in records)}
    # ---- the collective audit (rank 0 prints its line)
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        audit = collective_audit.main(["-c", SMOKE_PRETRAIN, "--arch", "vit_micro",
                                       "--batch", "2", "--steps", "2", "--device", "cpu"])
    out["audit"] = audit
    out["audit_printed"] = printed.getvalue()
    with open(os.path.join(out_dir, f"cli_rank{me}.json"), "w") as f:
        json.dump(out, f, default=float)


def main():
    _orphan_watchdog()
    suite, out_dir = sys.argv[1], sys.argv[2]
    sys.path.insert(0, REPO)
    import torch

    torch.set_num_threads(1)
    from ccd_tpu_torch.parallel.mesh import init_distributed, rank, world

    _device, group = init_distributed(torch.device("cpu"))
    me, n = rank(group), world(group)
    {"steps": _steps_suite, "cli": _cli_suite, "tp": _tp_suite}[suite](out_dir, group, me, n)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
