"""Checkpoint file names, copied from ``accelerate_tpu/utils/constants.py``
so that the two packages read and write one directory layout."""

MODEL_NAME = "model"
ORBAX_DIR_NAME = "distributed_state"  # DISTRIBUTED_STATE_DICT (orbax): not ported
OPTIMIZER_NAME = "optimizer"
SCHEDULER_NAME = "scheduler"
SAMPLER_NAME = "sampler"
RNG_STATE_NAME = "random_states"
SCALER_NAME = "scaler"

SAFE_WEIGHTS_NAME = "model.safetensors"
SAFE_WEIGHTS_INDEX_NAME = "model.safetensors.index.json"

# Shard size of SHARDED_STATE_DICT safetensors.
MAX_SHARD_SIZE = "5GB"

# An automatic checkpoint directory under <project_dir>/checkpoints.
CHECKPOINT_DIR_REGEX = r"^checkpoint_(\d+)$"
