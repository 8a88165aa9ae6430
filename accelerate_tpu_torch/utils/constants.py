"""Checkpoint file names and the exit-code protocol, copied from
``accelerate_tpu/utils/constants.py`` so that the two packages read and
write one directory layout and classify exits alike."""

MODEL_NAME = "model"
# The JAX package's DISTRIBUTED_STATE_DICT directory (orbax), which the port
# does not read, and the port's own (torch.distributed.checkpoint). The
# names differ so that neither package opens the other's format by mistake.
ORBAX_DIR_NAME = "distributed_state"
DCP_DIR_NAME = "distributed_state_torch"
OPTIMIZER_NAME = "optimizer"
SCHEDULER_NAME = "scheduler"
SAMPLER_NAME = "sampler"
RNG_STATE_NAME = "random_states"
SCALER_NAME = "scaler"

SAFE_WEIGHTS_NAME = "model.safetensors"
SAFE_WEIGHTS_INDEX_NAME = "model.safetensors.index.json"

# Shard size of SHARDED_STATE_DICT safetensors.
MAX_SHARD_SIZE = "5GB"

# An automatic checkpoint directory under <project_dir>/checkpoints. Under
# fault tolerance a save writes into <dir>.tmp and renames it after
# manifest.json lists every file (fault_tolerance.py).
CHECKPOINT_DIR_REGEX = r"^checkpoint_(\d+)$"
CHECKPOINT_STAGING_SUFFIX = ".tmp"
CHECKPOINT_MANIFEST_NAME = "manifest.json"

# The quarantine record a sticky silent-data-corruption conviction writes
# into the project directory (sdc.py).
SDC_QUARANTINE_FILE = "sdc_quarantine.json"

# ----------------------------------------------------------------------
# Exit-code protocol, copied from the JAX package so that one supervisor
# classifies both packages' exits: the codes a worker exits with on
# purpose, and what the shell's signal conventions give the rest. The
# flight recorder (profiler.py) names its dumps by the classification.
# ----------------------------------------------------------------------

PREEMPTION_EXIT_CODE = 75
TRAINING_STALLED_EXIT_CODE = 76
POISONED_CHECKPOINT_EXIT_CODE = 77
SERVING_CRASH_EXIT_CODE = 78
SDC_EXIT_CODE = 79
CELL_DEAD_EXIT_CODE = 80
FLEET_DEGRADED_EXIT_CODE = 81

EXIT_CODE_TABLE = (
    # (code, constant, classification, supervisor response)
    {"code": 0, "constant": None, "classification": "ok",
     "response": "stop — clean exit"},
    {"code": PREEMPTION_EXIT_CODE, "constant": "PREEMPTION_EXIT_CODE",
     "classification": "preempted",
     "response": "relaunch with zero backoff; elastic resume restores the "
                 "preemption auto-save"},
    {"code": TRAINING_STALLED_EXIT_CODE, "constant": "TRAINING_STALLED_EXIT_CODE",
     "classification": "stalled",
     "response": "relaunch with backoff from the newest verified checkpoint"},
    {"code": POISONED_CHECKPOINT_EXIT_CODE,
     "constant": "POISONED_CHECKPOINT_EXIT_CODE",
     "classification": "poisoned",
     "response": "refuse — a relaunch replays the same divergence"},
    {"code": SERVING_CRASH_EXIT_CODE, "constant": "SERVING_CRASH_EXIT_CODE",
     "classification": "serving-crash",
     "response": "relaunch with zero backoff; recover() replays the journal"},
    {"code": SDC_EXIT_CODE, "constant": "SDC_EXIT_CODE",
     "classification": "sdc",
     "response": "relaunch SHRUNK with zero backoff, quarantined host "
                 "excluded (persisted in the quarantine file)"},
    {"code": CELL_DEAD_EXIT_CODE, "constant": "CELL_DEAD_EXIT_CODE",
     "classification": "cell-dead",
     "response": "relaunch the cell with zero backoff; the fleet router "
                 "already drained its journal onto survivors"},
    {"code": FLEET_DEGRADED_EXIT_CODE, "constant": "FLEET_DEGRADED_EXIT_CODE",
     "classification": "fleet-degraded",
     "response": "relaunch with backoff — every cell is breaching, more "
                 "capacity is the fix, not a faster restart"},
    {"code": 130, "constant": None, "classification": "interrupted",
     "response": "stop — the operator hit Ctrl-C"},
    {"code": 137, "constant": None, "classification": "oom",
     "response": "relaunch with backoff (kernel OOM kill)"},
    {"code": 139, "constant": "DEAD_HOST_DEFAULT_EXIT_CODE (chaos.py)",
     "classification": "dead-host",
     "response": "relaunch with backoff; --shrink_after_dead_hosts=K shrinks "
                 "after K consecutive deaths"},
)

# The crash flight bundle (profiler.FlightRecorder), named by the exit's
# classification (flight_serving-crash.json, flight_sdc.json, ...), written
# to $ACCELERATE_FLIGHT_DIR when set, else the project directory or the
# working directory.
FLIGHT_RECORD_PATTERN = "flight_{exit_class}.json"
FLIGHT_DIR_ENV = "ACCELERATE_FLIGHT_DIR"
