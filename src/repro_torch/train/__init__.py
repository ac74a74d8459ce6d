"""Single-device training of the port: AdamW and the train step."""

from repro_torch.train.optimizer import AdamWConfig, adamw_init, adamw_update
from repro_torch.train.step import TrainStepBuilder

__all__ = ["AdamWConfig", "TrainStepBuilder", "adamw_init", "adamw_update"]
