"""Trainer and checkpoints (follows deepxi_tpu/training/)."""

from deepxi_tpu_torch.training.trainer import (ClipAdam, TrainState,
                                               append_loss_csv,
                                               checkpoint_params, frame_mask,
                                               gather_state, shard_state, shardings_of,
                                               make_eval_step, make_optimizer,
                                               make_phoneme_train_step,
                                               make_train_step, masked_loss,
                                               restore_checkpoint,
                                               save_checkpoint,
                                               transformer_schedule)

__all__ = ["ClipAdam", "TrainState", "append_loss_csv", "checkpoint_params",
           "frame_mask",
           "make_eval_step", "make_optimizer", "make_phoneme_train_step", "make_train_step", "masked_loss",
           "restore_checkpoint", "save_checkpoint", "gather_state", "shard_state",
           "shardings_of", "transformer_schedule"]
