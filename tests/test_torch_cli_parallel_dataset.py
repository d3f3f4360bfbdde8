"""``train-gnn --model pose --device-dataset --devices 2`` of the port's
CLI (two gloo ranks on the CPU) against the JAX CLI's ``--devices 2`` and
the port in one process, from one JAX checkpoint (the host-batched form is
in ``test_torch_cli_parallel.py``)."""

import pytest
import torch

from test_torch_cli_parallel import build_both, devices_case

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    return build_both(tmp_path_factory)


def test_train_gnn_device_dataset_devices_matches_single_and_jax(built, capfd):
    devices_case(built, ["--device-dataset"], capfd)
