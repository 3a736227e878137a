"""Atomic, checksummed checkpoints of tensor trees (port of
``repro.checkpoint``); the on-disk format is the reference's, so either
package restores what the other wrote."""

from repro_torch.checkpoint.checkpoint import (AsyncCheckpointer, latest_checkpoint,
                                               list_checkpoints, load_manifest,
                                               map_named_leaves, prune_checkpoints,
                                               restore_checkpoint, save_checkpoint)
