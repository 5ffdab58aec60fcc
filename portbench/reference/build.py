"""The plain reference built from a configuration file: TFlow and the SSF
pipeline of ``plain/`` in float32 with TF32 off, from the same
committed weights the program loads (or, with ``quant``, their Dense
layers through a lower precision: the control)."""

from __future__ import annotations

import os

from portbench.harness import ROOT


def float32_only() -> None:
    """TF32 off for every float32 product of the reference."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def flownet_config(config: dict):
    from portbench.reference.plain.config import FlowNetConfig

    net = dict(config["flownet"], dtype="float32")
    return FlowNetConfig(**{k: tuple(map(tuple, v)) if k == "sa_mlps"
                            else tuple(v) if isinstance(v, list) else v
                            for k, v in net.items()})


def pipeline_config(config: dict):
    from portbench.reference.plain.config import LidarConfig, PipelineConfig

    return PipelineConfig(lidar=LidarConfig(
        max_points=config["flownet"]["npoint"]))


def load_tflow(config: dict, device, quant: str | None = None):
    from portbench.reference.plain.weights import load_tflow as load

    float32_only()
    return load(flownet_config(config), os.path.join(ROOT, config["weights"]),
                device, quant)

