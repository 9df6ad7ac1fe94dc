"""Finetuning traffic: ``make_multi_finetune_step`` over staged chunks of
uint8 word crops and their padded targets, with the configuration's
augmentation, from the end of the warm-up on."""

from __future__ import annotations

from typing import List

import numpy as np

from portbench.drivers.training import TrainingJob, cosine_total
from portbench.drivers.recognizer import build_recognizer
from portbench.reference.models.layers import set_fp8


class Job(TrainingJob):
    loss_keys = ("loss",)

    def charset(self) -> str:
        return "".join(self.ctx.side.DICTS[self.cfg["dataset"]["charset_type"]])

    def aux(self, masks: np.ndarray, words: List[str]) -> np.ndarray:
        d = self.cfg["decoder"]
        convertor = self.ctx.side.AttnConvertor(dict_type=self.cfg["dataset"]["charset_type"],
                                                max_seq_len=d["max_seq_len"], with_unknown=True)
        return convertor.str2tensor(words).astype(np.int32)

    def schedule(self) -> dict:
        c = self.cfg
        global_batch = self.batch
        per_epoch, total = cosine_total(c["training"]["epochs"], c["assumed"]["train_images"],
                                        global_batch)
        return dict(base_lr=float(c["lr"]), min_lr=float(c["min_lr"] or 0.0), total_iters=total,
                    warmup_iters=int((c["warmup_epochs"] or 0) * per_epoch),
                    weight_decay=float(c["weight_decay"]), clip_grad=c["clip_grad"])

    def build(self, side, dtype, fp8: bool):
        model, _ = build_recognizer(side, self.cfg, self.device, dtype, self.ctx.seed)
        if fp8:
            set_fp8(model)
        state = side.init_finetune_state(model, seed=self.ctx.seed)
        schedule = self.schedule()
        state.iteration = schedule["warmup_iters"]
        aug = side.supervised_augment if self.cfg["dataset"]["data_aug"] else None
        return state, side.make_multi_finetune_step(aug_fn=aug, **schedule), model
