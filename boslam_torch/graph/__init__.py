from boslam_torch.graph.data import FactorGraph, GraphMeta
from boslam_torch.graph.build import build_graph

__all__ = ["FactorGraph", "GraphMeta", "build_graph"]
