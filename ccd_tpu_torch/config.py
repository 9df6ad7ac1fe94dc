"""YAML configuration with template merging and prefix-flattened attribute access.

Behavior parity with the reference ``Config`` (``Dino/utils/utils.py:191-237``):
  * the user YAML is merged over ``ccd_tpu_torch/configs/template.yaml`` defaults,
  * nested dicts are flattened to ``<section>_<key>`` attributes,
  * attribute access on a missing name re-groups every ``<name>_*`` attribute
    into a dict, or returns ``None`` when nothing matches,
  * ``global_workdir`` is joined with ``global_name``.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional

import yaml

_TEMPLATE_PATH = os.path.join(os.path.dirname(__file__), "configs", "template.yaml")

_VALID_PHASES = ("train", "test")
_VALID_STAGES = (
    "pretrain-vision",
    "pretrain-language",
    "pretrain-fusion",
    "train-semi-supervised",
    "train-supervised",
)


class Config:
    """Flattened-attribute config loaded from YAML over template defaults."""

    def __init__(self, config_path: str, template_path: Optional[str] = _TEMPLATE_PATH):
        if not os.path.exists(config_path):
            raise FileNotFoundError(f"{config_path} does not exist!")
        with open(config_path) as f:
            config_dict = yaml.safe_load(f) or {}
        if template_path and os.path.exists(template_path):
            with open(template_path) as f:
                template_dict = yaml.safe_load(f) or {}
            self._dict2attr(template_dict)
        self._dict2attr(config_dict)
        if getattr(self, "global_workdir", None) and getattr(self, "global_name", None):
            self.global_workdir = os.path.join(self.global_workdir, self.global_name)

    def _dict2attr(self, d: Dict[str, Any], prefix: str = "") -> None:
        for k, v in d.items():
            if isinstance(v, dict):
                self._dict2attr(v, f"{prefix}{k}_")
            else:
                if k == "phase" and v is not None:
                    assert v in _VALID_PHASES, f"invalid phase {v!r}"
                if k == "stage" and v is not None:
                    assert v in _VALID_STAGES, f"invalid stage {v!r}"
                setattr(self, f"{prefix}{k}", v)

    def __getattr__(self, item: str) -> Any:
        # only called when normal lookup fails
        if item.startswith("__"):
            raise AttributeError(item)
        prefix = f"{item}_"
        group = {
            k[len(prefix):]: v for k, v in self.__dict__.items() if k.startswith(prefix)
        }
        return group if group else None

    def override(self, **kwargs: Any) -> "Config":
        """Apply non-None CLI overrides onto flattened attributes."""
        for k, v in kwargs.items():
            if v is not None:
                setattr(self, k, v)
        return self

    def __repr__(self) -> str:
        lines = ["Config("]
        for i, (k, v) in enumerate(sorted(vars(self).items())):
            lines.append(f"\t({i}): {k} = {v}")
        lines.append(")")
        return "\n".join(lines)
