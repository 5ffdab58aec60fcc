"""The system under test, built from a configuration file: the port's
TFlow with the committed weights, and its pipeline settings.
Only this module and the loops import the port (``ssf_slam_tpu_torch``)."""

from __future__ import annotations

import os

from portbench.harness import ROOT


def pipeline_config(config: dict):
    from ssf_slam_tpu_torch.config import LidarConfig, PipelineConfig

    return PipelineConfig(lidar=LidarConfig(
        max_points=config["flownet"]["npoint"]))


def flownet_config(config: dict):
    from ssf_slam_tpu_torch.config import FlowNetConfig

    return FlowNetConfig(**{k: tuple(map(tuple, v)) if k == "sa_mlps"
                            else tuple(v) if isinstance(v, list) else v
                            for k, v in config["flownet"].items()})


def load_tflow(config: dict, device):
    from ssf_slam_tpu_torch.weights import load_tflow as load

    return load(flownet_config(config),
                path=os.path.join(ROOT, config["weights"]), device=device)

