"""Cells groups for sharded fleet serving (counterpart of the cells half
of ``repro.sharding``): see :mod:`repro_torch.sharding.runtime`."""
from repro_torch.sharding.runtime import (CELLS_AXIS, COLLECTIVES, CellsGroup,
                                          MeshInfo, all_gather_object,
                                          all_reduce, backend_for, cells_group,
                                          destroy_cells_group, get_mesh_info,
                                          reset_collective_counts,
                                          set_mesh_info, spawn_cells)

__all__ = [
    "CELLS_AXIS", "COLLECTIVES", "CellsGroup", "MeshInfo",
    "all_gather_object", "all_reduce", "backend_for", "cells_group",
    "destroy_cells_group",
    "get_mesh_info", "reset_collective_counts", "set_mesh_info",
    "spawn_cells",
]
