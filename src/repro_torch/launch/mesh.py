"""The one-card mesh (after the JAX package's launch/mesh.py).

The JAX package builds device meshes of 256 and 512 chips, and a small one
for its multi-device tests; the port runs on one card, so its mesh is a
record of the same two axes, ("data", "model"), both of size 1, with the
same size helpers. It builds no device mesh and no torch.distributed
process group."""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple


@dataclasses.dataclass(frozen=True)
class OneCardMesh:
    """The mesh of one card: its axis names and sizes, and its tag in the
    dry run's records."""
    axis_names: Tuple[str, ...] = ("data", "model")
    shape: Tuple[int, ...] = (1, 1)
    tag: str = "1xH100"

    @property
    def size(self) -> int:
        return 1


def make_mesh() -> OneCardMesh:
    return OneCardMesh()


def mesh_axis_sizes(mesh: OneCardMesh) -> Dict[str, int]:
    return dict(zip(mesh.axis_names, mesh.shape))


def dp_size(mesh: OneCardMesh) -> int:
    sizes = mesh_axis_sizes(mesh)
    return sizes.get("data", 1) * sizes.get("pod", 1)


def tp_size(mesh: OneCardMesh) -> int:
    return mesh_axis_sizes(mesh).get("model", 1)
