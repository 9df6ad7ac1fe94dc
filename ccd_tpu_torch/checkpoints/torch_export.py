"""The port's models out in the reference's checkpoint layout.

Counterpart of ``ccd_tpu/checkpoints/torch_export.py``, working from the
port's modules and ``state_dict``s instead of Flax trees. The port's modules
already carry the reference's parameter names, so the export is the port's
own ``state_dict`` with what the reference holds and the port has no use for
put back, so that the reference stack (and the JAX package's
``torch_import``) loads the file strictly:

  * ``backbone.cls_token``: zeros ``(1, 1, C)``; the reference registers the
    parameter and never prepends it (``vision_transformer.py:146,230-231``);
  * ``decoder.position_enc.position_table``: the sinusoid table of 200
    positions (``transformer_module.py:136-153``), which the port recomputes;
  * ``num_batches_tracked``: an int64 zero beside every BatchNorm's running
    statistics (torch reads it only for ``momentum=None``; the reference's
    is fixed);
  * ``segmentation.conv_mla.*``: the ``Conv_MLA`` submodule the reference
    builds and never calls (``segmentor.py:80``, skipped by ``:90-95``), as
    deterministic identity-BatchNorm filler sized from ``head2``'s first
    convolution.

Written files:

  * finetune: ``{'net': state_dict, 'iteration': int}``, the layout the
    reference's ``test.py:165-173`` loads and ``train_finetune.py:237-256``
    resumes from;
  * pretrain: ``{'student': sd, 'teacher': sd, 'epoch': int, 'iteration':
    int}``, the layout ``train_finetune.py:191-200`` reads for the
    teacher-to-backbone hand-off.

Every function takes a live ``nn.Module``, a ``state_dict``, or a payload of
this package's trainers (``finetune_state_payload`` /
``pretrain_state_payload``, as a dict or as the file the trainer wrote:
``best_accuracy.pt``, ``ckpt_<step>.pt``). Tensors go out fp32 (the int64
counters as int64), on the CPU, contiguous, each a copy.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Tuple, Union

import torch
from torch import nn

from ccd_tpu_torch.models.nrtr import sinusoid_table

StateSource = Union[nn.Module, Mapping[str, Any], str]

# the reference's position table length (transformer_module.py:136, n_position)
_N_POSITION = 200
# Conv_MLA's branches: name -> (input channels "in" or "mla", kernel size)
_CONV_MLA = (("mla_p2_1x1", "in", 1), ("mla_p3_1x1", "in", 1), ("mla_p4_1x1", "in", 1),
             ("mla_p2", "mla", 3), ("mla_p3", "mla", 3), ("mla_p4", "mla", 3))


def _load(source: StateSource) -> Any:
    if isinstance(source, str):
        return torch.load(source, map_location="cpu", weights_only=True)
    return source


def _state_dict(source: Any, branch: Optional[str] = None) -> Dict[str, torch.Tensor]:
    """A module's ``state_dict``, or the ``branch`` entry of a payload, or
    the mapping itself; the ``module.`` prefix of a ``DataParallel`` save is
    stripped."""
    if isinstance(source, nn.Module):
        sd = source.state_dict()
    elif branch is not None and isinstance(source, Mapping) and branch in source:
        sd = source[branch]
    else:
        sd = source
    return {(k[len("module."):] if k.startswith("module.") else k): v for k, v in sd.items()}


def _out(t: torch.Tensor) -> torch.Tensor:
    dtype = torch.int64 if t.dtype == torch.int64 else torch.float32
    return t.detach().to(device="cpu", dtype=dtype, copy=True).contiguous()


def _with_reference_extras(sd: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Copy ``sd`` out, putting the cls token after ``pos_embed``, the
    position table after the word embedding and a counter after every
    running variance, where they are missing."""
    out: Dict[str, torch.Tensor] = {}
    for name, value in sd.items():
        out[name] = _out(value)
        if name == "backbone.pos_embed" and "backbone.cls_token" not in sd:
            out["backbone.cls_token"] = torch.zeros((1, 1, value.shape[-1]), dtype=torch.float32)
        elif (name == "decoder.trg_word_emb.weight"
              and "decoder.position_enc.position_table" not in sd):
            out["decoder.position_enc.position_table"] = torch.from_numpy(
                sinusoid_table(_N_POSITION, value.shape[-1]))
        elif name.endswith(".running_var"):
            counter = name[:-len("running_var")] + "num_batches_tracked"
            if counter not in sd:
                out[counter] = torch.zeros((), dtype=torch.int64)
    return out


def _conv_mla_filler(sd: Dict[str, torch.Tensor], prefix: str = "segmentation.") -> None:
    """The reference's never-called ``Conv_MLA`` weights: zero convolutions
    and identity BatchNorms, channel counts from ``head2``'s first conv."""
    mla, c_in = sd[f"{prefix}mlahead.head2.0.weight"].shape[:2]
    for name, fan, k in _CONV_MLA:
        p = f"{prefix}conv_mla.{name}"
        ci = c_in if fan == "in" else mla
        sd.setdefault(f"{p}.0.weight", torch.zeros((mla, ci, k, k), dtype=torch.float32))
        sd.setdefault(f"{p}.1.weight", torch.ones((mla,), dtype=torch.float32))
        sd.setdefault(f"{p}.1.bias", torch.zeros((mla,), dtype=torch.float32))
        sd.setdefault(f"{p}.1.running_mean", torch.zeros((mla,), dtype=torch.float32))
        sd.setdefault(f"{p}.1.running_var", torch.ones((mla,), dtype=torch.float32))
        sd.setdefault(f"{p}.1.num_batches_tracked", torch.zeros((), dtype=torch.int64))


def _refuse_head_batchnorm(sd: Mapping[str, torch.Tensor]) -> None:
    """A DINOHead built with ``use_bn_in_head`` is not exported: the JAX
    package's exporter writes only its ``mlp_j`` Dense layers and would drop
    the BatchNorms without a word, so there is no export to hold this one
    to, and the reference's ``BatchNorm1d`` keeps an unbiased running
    variance where the port (as Flax) keeps the biased one."""
    bn = sorted(k for k in sd if k.startswith("head.mlp.") and k.endswith(".running_mean"))
    if bn:
        raise ValueError(f"the DINO head has BatchNorm layers ({', '.join(bn)}): a "
                         "use_bn_in_head head cannot be exported to the reference layout")


def recognizer_reference_state_dict(model_or_sd: StateSource, module_prefix: bool = False
                                    ) -> Dict[str, torch.Tensor]:
    """A ``CCDRecognizer`` (module, ``state_dict``, finetune payload or its
    file) -> the reference ``DINO_Finetune`` ``state_dict``.

    ``module_prefix``: prepend ``module.``, as the reference saves from a
    ``nn.DataParallel``-wrapped model (``train_finetune.py:373-378``), so
    released-style checkpoints carry the prefix."""
    sd = _with_reference_extras(_state_dict(_load(model_or_sd), "net"))
    if module_prefix:
        sd = {f"module.{k}": v for k, v in sd.items()}
    return sd


def pretrain_reference_state_dicts(student: StateSource, teacher: Optional[StateSource] = None
                                   ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """The pretraining student (with its SegHead) and teacher -> the
    reference ``ABIDINOModel`` ``state_dict``s ``(student, teacher)``.

    ``student`` may also be a whole pretraining payload (or its file), which
    holds both; ``teacher`` is then left out. A DINOHead with BatchNorm
    (``use_bn_in_head``) raises ``ValueError``."""
    student = _load(student)
    if teacher is None:
        if not (isinstance(student, Mapping) and {"student", "teacher"} <= set(student)):
            raise ValueError("pretrain_reference_state_dicts: no teacher given and the "
                             "student is not a pretraining payload")
        teacher = student
    student_sd = _state_dict(student, "student")
    teacher_sd = _state_dict(_load(teacher), "teacher")
    _refuse_head_batchnorm(student_sd)
    _refuse_head_batchnorm(teacher_sd)
    student_sd = _with_reference_extras(student_sd)
    if any(k.startswith("segmentation.") for k in student_sd):
        _conv_mla_filler(student_sd)
    return student_sd, _with_reference_extras(teacher_sd)


def save_recognizer_torch(model_or_payload: StateSource, path: str, iteration: int = 0,
                          module_prefix: bool = False) -> None:
    """Write a ``{'net', 'iteration'}`` file that the reference's
    ``test.py:165-173`` / ``train_finetune.py:237-256`` load, and this
    package's ``builders.load_recognizer_params`` reads back."""
    torch.save({"net": recognizer_reference_state_dict(model_or_payload, module_prefix),
                "iteration": int(iteration)}, path)


def save_pretrain_torch(student: StateSource, teacher: Optional[StateSource], path: str,
                        epoch: int = 0, iteration: int = 0) -> None:
    """Write a ``{'student', 'teacher', 'epoch', 'iteration'}`` file for the
    reference's hand-off (``train_finetune.py:191-200`` reads
    ``ckpt['teacher']`` by name), which this package's
    ``builders.load_pretrained_backbone`` reads too. Pass a pretraining
    payload (or its file) as ``student`` and None as ``teacher`` to export a
    checkpoint of the ``train`` CLI."""
    student_sd, teacher_sd = pretrain_reference_state_dicts(student, teacher)
    torch.save({"student": student_sd, "teacher": teacher_sd, "epoch": int(epoch),
                "iteration": int(iteration)}, path)
