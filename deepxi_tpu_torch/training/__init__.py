"""Trainer and checkpoints (follows deepxi_tpu/training/)."""

from deepxi_tpu_torch.training.trainer import (ClipAdam, TrainState,
                                               append_loss_csv, frame_mask,
                                               make_eval_step, make_optimizer,
                                               make_train_step, masked_loss,
                                               restore_checkpoint,
                                               save_checkpoint,
                                               transformer_schedule)

__all__ = ["ClipAdam", "TrainState", "append_loss_csv", "frame_mask",
           "make_eval_step", "make_optimizer", "make_train_step", "masked_loss",
           "restore_checkpoint", "save_checkpoint", "transformer_schedule"]
