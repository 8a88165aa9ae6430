"""Probes for the optional tracker packages, as
``accelerate_tpu/utils/imports.py`` has them: a package counts as available
when its module can be found, without importing it."""

import functools
import importlib.metadata
import importlib.util


@functools.lru_cache(maxsize=None)
def _is_package_available(pkg_name: str) -> bool:
    if importlib.util.find_spec(pkg_name) is None:
        return False
    try:
        importlib.metadata.version(pkg_name)
    except importlib.metadata.PackageNotFoundError:
        pass  # a namespace package has no metadata and imports all the same
    return True


def is_tensorboard_available() -> bool:
    return _is_package_available("tensorboardX") or _is_package_available("tensorboard")


def is_wandb_available() -> bool:
    return _is_package_available("wandb")


def is_comet_ml_available() -> bool:
    return _is_package_available("comet_ml")


def is_aim_available() -> bool:
    return _is_package_available("aim")


def is_mlflow_available() -> bool:
    return _is_package_available("mlflow")


def is_clearml_available() -> bool:
    return _is_package_available("clearml")


def is_dvclive_available() -> bool:
    return _is_package_available("dvclive")


def is_swanlab_available() -> bool:
    return _is_package_available("swanlab")


def is_trackio_available() -> bool:
    return _is_package_available("trackio")
