"""Pretraining traffic: ``make_multi_pretrain_step`` over staged chunks of
uint8 word crops and their glyph masks (the ground-truth-mask regime), from
the end of the learning-rate warm-up on."""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from portbench.drivers.training import TrainingJob, cosine_total
from portbench.reference.models.layers import set_fp8
from portbench.weights import load_weights


class Job(TrainingJob):
    loss_keys = ("loss", "mask_loss", "dino_loss")

    def charset(self) -> str:
        """The 36 lower-case letters and digits of ``charset_36.txt``."""
        if not self.cfg["dataset"]["charset_path"].endswith("charset_36.txt"):
            raise ValueError(f"no character set for {self.cfg['dataset']['charset_path']!r}")
        return "".join(self.ctx.side.DICTS["DICT36"])

    def aux(self, masks: np.ndarray, words: List[str]) -> np.ndarray:
        return masks

    def setup(self) -> None:
        super().setup()
        self.traffic["mean_slots"] = self.mean_slots()

    def mean_slots(self) -> float:
        """Character slots with glyph pixels, a checked image's mean: what the
        ground-truth clusters give the pooling (``label_clusters`` of the
        reference, 26 slots, components of 30 pixels or more)."""
        from portbench.reference.ops.cc_label import label_clusters
        masks = torch.from_numpy(self.first_rows[1]).to(self.device).flatten(0, 1).float()
        clusters = label_clusters(masks, num_slots=26)
        return float((clusters.flatten(2).amax(-1) > 0).sum(-1).float().mean())

    def schedule(self, side) -> dict:
        c = self.cfg
        global_batch = self.batch
        per_epoch, total = cosine_total(c["training"]["epochs"], c["assumed"]["train_images"],
                                        global_batch)
        nepochs = int(total * global_batch / c["imgnet_based"]) + 1
        return dict(
            base_lr=float(c["lr"]) * global_batch / 256.0, min_lr=float(c["min_lr"]),
            total_iters=total,
            warmup_iters=int(c["warmup_epoch"] * c["imgnet_based"] / global_batch),
            weight_decay=float(c["weight_decay"]), weight_decay_end=float(c["weight_decay_end"]),
            momentum_teacher=float(c["momentum_teacher"]),
            teacher_temps=side.teacher_temp_schedule(
                float(c["warmup_teacher_temp"]), float(c["teacher_temp"]),
                int(c["warmup_teacher_temp_epochs"]), nepochs),
            clip_grad=c["clip_grad"], freeze_last_layer=int(c["freeze_last_layer"]),
            global_batch=global_batch, imgnet_based=int(c["imgnet_based"]))

    def build(self, side, dtype, fp8: bool):
        c = self.cfg
        kw = dict(arch=c["arch"], patch_size=c["patch_size"], out_dim=c["out_dim"],
                  use_bn_in_head=bool(c["use_bn_in_head"]), dtype=dtype)
        with torch.device(self.device):
            student = side.CCDPretrainModel(drop_path_rate=c["drop_path_rate"],
                                            norm_last_layer=bool(c["norm_last_layer"]),
                                            with_seg_head=True, **kw)
            teacher = side.CCDPretrainModel(drop_path_rate=0.0, norm_last_layer=True,
                                            with_seg_head=False, **kw)
        student, teacher = student.to(self.device), teacher.to(self.device)
        load_weights(student, self.ctx.seed)
        if fp8:
            set_fp8(student), set_fp8(teacher)
        state = side.init_pretrain_state(student, teacher, seed=self.ctx.seed,
                                         optimizer=str(c["optimizer"]))
        schedule = self.schedule(side)
        state.iteration = schedule["warmup_iters"]
        step = side.make_multi_pretrain_step(
            severity=int(c["dataset"]["augmentation_severity"]), **schedule)
        return state, step, student
