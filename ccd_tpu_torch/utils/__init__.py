from ccd_tpu_torch.utils.device import resolve_device
from ccd_tpu_torch.utils.logging import Logger
from ccd_tpu_torch.utils.meters import MetricLogger, SmoothedValue

__all__ = ["resolve_device", "Logger", "MetricLogger", "SmoothedValue"]
