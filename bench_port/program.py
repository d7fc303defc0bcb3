"""The program under test, as the benchmark builds it: a computer from a
configuration's ``"computer"`` block on this process's device, and the
process group and mesh of a cell on several cards."""

import datetime

import torch

from .common import AOT_STORE

__all__ = ["aot_store", "computer", "start_group"]


def computer(config: dict, device: torch.device):
    """The configuration's frame computer, on ``device``."""
    from speech_tpu_torch.alias import alias_factory_subclass_from_arg
    from speech_tpu_torch.compute import FrameComputer

    return alias_factory_subclass_from_arg(FrameComputer, {**config["computer"], "device": device})


def aot_store(device: torch.device):
    """The kernel-library store inside the checkout (on a card), made the
    process default too, so that no library is built elsewhere."""
    if device.type != "cuda":
        return None
    from speech_tpu_torch import aot

    return aot.set_default_store(str(AOT_STORE))


def start_group(rank: int, world: int, port: int, device: torch.device):
    """The default process group (NCCL on cards, gloo on the CPU) at
    ``tcp://localhost:port``, a gloo group for the benchmark's own
    agreements, and the mesh of the program's extractor."""
    import torch.distributed as dist

    from speech_tpu_torch.parallel import make_mesh, multihost

    backend = "nccl" if device.type == "cuda" else "gloo"
    multihost.initialize(coordinator_address=f"localhost:{port}", num_processes=world,
                         process_id=rank, backend=backend,
                         timeout=datetime.timedelta(seconds=300))
    control = dist.new_group(backend="gloo")
    return make_mesh(("data",), devices=device.type), control
