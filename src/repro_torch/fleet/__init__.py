"""Fleet-scale vectorized simulation on tensors.

    latency   the latency model batched over a leading cell axis
    env       FleetEnv: init / observe / transition / step over stacked
              cell state, with the tier economy's state on
              ``FleetState.econ`` under ``FleetConfig.economy``, and one
              rank's block of a fleet under ``FleetConfig.cells_group``
    workload  Table-IV fleets, random topologies, curriculum stages,
              Poisson round traces; a rank's block of a fleet
              (``FleetScenario.shard``, ``CellBlock``)
    solver    the exact occupancy-count optimizer (numpy, host-side)
    evaluate  batched policy rounds, the greedy evaluator and the
              throughput runner
"""
from repro_torch.fleet.workload import (CellBlock, FleetScenario,
                                        from_table4, random_fleet,
                                        curriculum_fleets)
from repro_torch.fleet.env import FleetConfig, FleetState, make_fleet_env
from repro_torch.fleet.solver import solve_optimal, solve_fleet
from repro_torch.fleet.evaluate import (make_greedy_evaluator,
                                        make_throughput_runner,
                                        run_policy_round)

__all__ = [
    "CellBlock", "FleetScenario", "from_table4", "random_fleet", "curriculum_fleets",
    "FleetConfig", "FleetState", "make_fleet_env",
    "solve_optimal", "solve_fleet",
    "make_greedy_evaluator", "make_throughput_runner", "run_policy_round",
]
