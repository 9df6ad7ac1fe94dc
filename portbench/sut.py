"""The two sides of a comparison, behind one set of names: the system under
test (``ccd_tpu_torch``, the program) and the benchmark's plain reference
(``portbench/reference``). The drivers reach every model, step and
convertor through these names, so the reference, or its lower-precision
control, can stand in the program's place."""

from __future__ import annotations

from types import SimpleNamespace


def program() -> SimpleNamespace:
    """The port's entries that the cells drive."""
    from ccd_tpu_torch.charsets import DICTS
    from ccd_tpu_torch.convertor import AttnConvertor
    from ccd_tpu_torch.data.augment import supervised_augment
    from ccd_tpu_torch.evaluation.runner import decode
    from ccd_tpu_torch.losses import teacher_temp_schedule
    from ccd_tpu_torch.models.pretrain import CCDPretrainModel
    from ccd_tpu_torch.models.recognizer import CCDRecognizer
    from ccd_tpu_torch.training.finetune_step import (init_finetune_state,
                                                      make_multi_finetune_step)
    from ccd_tpu_torch.training.pretrain_step import (init_pretrain_state,
                                                      make_multi_pretrain_step)
    return SimpleNamespace(**{k: v for k, v in locals().items()}, name="program")


def reference() -> SimpleNamespace:
    """The same names in the plain reference."""
    from portbench.reference.charsets import DICTS
    from portbench.reference.convertor import AttnConvertor
    from portbench.reference.data.augment import supervised_augment
    from portbench.reference.evaluation import decode
    from portbench.reference.losses import teacher_temp_schedule
    from portbench.reference.models.pretrain import CCDPretrainModel
    from portbench.reference.models.recognizer import CCDRecognizer
    from portbench.reference.training.finetune_step import (init_finetune_state,
                                                            make_multi_finetune_step)
    from portbench.reference.training.pretrain_step import (init_pretrain_state,
                                                            make_multi_pretrain_step)
    return SimpleNamespace(**{k: v for k, v in locals().items()}, name="reference")
