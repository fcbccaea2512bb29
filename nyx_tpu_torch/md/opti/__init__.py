"""Optimization: differential correction and multiple shooting (torch port
of nyx_tpu/md/opti/, the reference's nyx-core/src/md/opti/)."""

from .convert_impulsive import convert_impulsive_mnvr
from .multishoot import CostFunction, MultipleShooting, MultipleShootingSolution, Node, equidistant_nodes
from .target_variable import Variable, Vary
from .targeter import Targeter, TargeterSolution

__all__ = [
    "Variable", "Vary", "Targeter", "TargeterSolution", "convert_impulsive_mnvr",
    "CostFunction", "MultipleShooting", "MultipleShootingSolution", "Node", "equidistant_nodes",
]
