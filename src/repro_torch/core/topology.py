"""Node-group topology: ordered node groups + per-edge links.

Only the part the static offload path needs so far: :class:`Topology` and
its 2-node constructor ``pair`` (the paper's primary/auxiliary testbed).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

from repro_torch.core.network import LinkModel
from repro_torch.core.offload import NodeGroup


@dataclass
class Topology:
    """``links[0]`` is None -- the hub's work never crosses a link;
    ``links[g]`` prices hub -> group g."""
    groups: List[NodeGroup]
    links: List[Optional[LinkModel]]
    kind: str = "pair"

    def __post_init__(self):
        if len(self.groups) < 2:
            raise ValueError("a topology needs at least hub + one spoke")
        if len(self.links) != len(self.groups):
            raise ValueError("need one link entry per group (hub's is None)")
        if any(l is None for l in self.links[1:]):
            raise ValueError("every spoke needs a LinkModel")
        names = [g.name for g in self.groups]
        if len(set(names)) != len(names):
            raise ValueError(f"group names must be unique, got {names}")

    @staticmethod
    def pair(primary: NodeGroup, auxiliary: NodeGroup,
             link: LinkModel) -> "Topology":
        """The paper's 2-node testbed: primary = hub, auxiliary = spoke."""
        return Topology([primary, auxiliary], [None, link], kind="pair")
