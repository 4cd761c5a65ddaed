"""Hybrid Learning training launcher of the port (the paper's experiment
driver).

Single-cell (the paper's testbed: the numpy env on the host, the
networks on the card):

    PYTHONPATH=src python -m repro_torch.launch.rl_train --algo HL \
        --users 5 --scenario A --constraint 89% [--seed 0] \
        [--max-steps N] [--ckpt hl_agent.bundle.msgpack] [--device cuda]

trains the HL agent (Algorithm 1), the DQL baseline or the tabular QL
baseline (host-side) on one ``EdgeCloudEnv`` until its greedy round is
within 1% of the brute-force optimum four evaluations in a row, printing
the reference CLI's lines (the optimum, the converged step, the final
ART and decisions, experience and compute minutes).

Fleet-scale (``--fleet``, HL only):

    PYTHONPATH=src python -m repro_torch.launch.rl_train --algo HL --fleet \
        --cells 256 --n-max 8 --epochs 60 [--chunk 5] [--no-curriculum] \
        [--obs-spec base|contention|constraint|full] \
        [--shared-cloud] [--shared-edge] [--cells-per-edge 4] \
        [--seed 0] [--ckpt hl.bundle.msgpack] [--device cuda]

trains one DQN and its system model on a fleet through
``repro_torch.hltrain``, by default over a user-count curriculum
2 → n_max of random fleets, one stage per chunk of epochs, then scores
the greedy policy against the exact solver optimum on the last stage and
on a held-out fleet.  Keys as the reference CLI's:
``k_fleet, k_init, k_eval = split(PRNGKey(seed), 3)`` draw the stages,
the trainer's carry and the evaluation; the held-out fleet is
``random_fleet(PRNGKey(seed + 1234))``.

``--ckpt`` (both paths) writes a PolicyBundle that either package loads
(``dqn`` with the system model's layers in ``meta["system"]`` for HL;
``qtable`` for QL); ``serve_fleet --bundle`` serves the fleet's.
"""
from __future__ import annotations

import argparse
import time

from repro_torch import random as rnd
from repro_torch.core.agent import ConvergenceTracker, HLAgent, HLHyperParams
from repro_torch.core.baselines import DQLAgent, QLAgent
from repro_torch.device import resolve_device, synchronize
from repro_torch.env.edge_cloud import (EdgeCloudEnv, EnvConfig,
                                        brute_force_optimal, decision_string)
from repro_torch.env.scenarios import CONSTRAINTS, SCENARIOS
from repro_torch.fleet.env import FleetConfig
from repro_torch.fleet.workload import curriculum_fleets, random_fleet
from repro_torch.hltrain.metrics import (evaluate_vs_solver,
                                         history_to_dict, optimal_rewards)
from repro_torch.hltrain.trainer import (FleetHLParams, make_hl_trainer,
                                         run_curriculum)
from repro_torch.policy.bundle import PolicyBundle, save_bundle
from repro_torch.specs.observation import SPEC_NAMES


def single_cell_agent(algo: str, env: EdgeCloudEnv, users: int, seed: int,
                      device):
    """The CLI's agent for ``algo`` with the reference CLI's
    hyper-parameters."""
    if algo == "HL":
        return HLAgent(env, HLHyperParams(
            seed=seed, epochs=400, eps_decay_steps=1000 * users, k_best=4,
            n_suggest=2 * users), device=device)
    if algo == "DQL":
        return DQLAgent(env, HLHyperParams(
            seed=seed, eps_decay_steps=6000 * users), device=device)
    return QLAgent(env)


def train_single(*, algo: str = "HL", users: int = 5, scenario: str = "A",
                 constraint: str = "89%", seed: int = 0,
                 max_steps: int | None = None, ckpt: str | None = None,
                 device="cuda", verbose: bool = True) -> dict:
    """Train one single-cell agent until convergence (or its cap) and
    (with ``ckpt``) write its bundle.  Returns the agent, its
    ``TrainResult``, the optimum, the tracker and the wall seconds of
    training (from after the optimum, as the reference CLI's clock)."""
    dev = resolve_device(device)

    def env(s):
        return EdgeCloudEnv(EnvConfig(SCENARIOS[scenario],
                                      CONSTRAINTS[constraint],
                                      n_users=users, seed=s))

    opt = brute_force_optimal(SCENARIOS[scenario], CONSTRAINTS[constraint],
                              users)
    if verbose:
        print(f"target optimum: ART={opt['art']:.1f} "
              f"{decision_string(opt['actions'])}")
    tracker = ConvergenceTracker(env(seed + 90), patience=4)
    t0 = time.perf_counter()
    agent = single_cell_agent(algo, env(seed), users, seed, dev)
    extra = {}
    if algo == "HL":
        res = agent.train(tracker=tracker)
        extra = {"system": agent.sm.params.to_layers()}
    elif algo == "DQL":
        res = agent.train(tracker=tracker, max_steps=max_steps or 300_000,
                          eval_every=200)
    else:
        res = agent.train(tracker=tracker, max_steps=max_steps or 2_000_000,
                          eval_every=2000)
    synchronize(dev)
    wall = time.perf_counter() - t0
    if verbose:
        print(f"\n{algo}: converged@{res.steps_to_converge} "
              f"(total {res.real_steps} interactions, {wall:.0f}s wall)")
        print(f"final ART={res.final_art:.1f} "
              f"decisions={decision_string(res.final_actions)}")
        print(f"experience time {res.exp_time_ms / 60000:.1f} min "
              f"(simulated), compute time {res.comp_time_s / 60:.2f} min")
    if ckpt:
        save_bundle(ckpt, PolicyBundle(
            kind=agent.policy.kind, obs_spec="base", n_max=users,
            params=agent.policy_params,
            meta={"algo": algo, "trainer": "python-single-cell",
                  "scenario": scenario, "constraint": constraint,
                  "final_art_ms": float(res.final_art), **extra}))
        if verbose:
            print(f"saved PolicyBundle → {ckpt} "
                  f"({agent.policy.kind}, spec 'base', n_max={users})")
    return dict(agent=agent, result=res, optimum=opt, tracker=tracker,
                wall_seconds=wall, algo=algo, device=dev)


def fleet_params(cells: int, epochs: int, seed: int) -> FleetHLParams:
    """The CLI's hyper-parameters: the defaults, with buffers that hold
    at least one fleet-wide write per step."""
    return FleetHLParams(seed=seed, epochs=epochs,
                         plan_cap=max(4096, cells),
                         direct_cap=max(65536, 8 * cells),
                         world_cap=max(65536, 8 * cells))


def train_fleet(*, cells: int = 256, n_max: int = 8, epochs: int = 60,
                chunk: int = 5, curriculum: bool = True,
                obs_spec: str = "base", shared_cloud: bool = False,
                shared_edge: bool = False, cells_per_edge: int = 1,
                seed: int = 0, ckpt: str | None = None, device="cuda",
                verbose: bool = True) -> dict:
    """Train, evaluate and (with ``ckpt``) write the bundle.  Returns the
    trainer's final state, the stages, each chunk's metrics and host
    seconds (synchronised), the training and solver host seconds and the
    two evaluations."""
    dev = resolve_device(device)
    cfg = FleetConfig(n_max=n_max, shared_cloud=shared_cloud,
                      shared_edge=shared_edge, obs_spec=obs_spec)
    hp = fleet_params(cells, epochs, seed)
    trainer = make_hl_trainer(cfg, hp)
    k_fleet, k_init, k_eval = rnd.split(rnd.PRNGKey(seed, dev), 3)
    chunk = max(1, chunk)
    n_stages = -(-epochs // chunk)  # ceil
    if curriculum:
        stages = curriculum_fleets(k_fleet, cells, n_stages, start=2,
                                   end=n_max, cells_per_edge=cells_per_edge)
    else:
        stages = [random_fleet(k_fleet, cells, n_max=n_max,
                               cells_per_edge=cells_per_edge)] * n_stages
    if verbose:
        print(f"fleet training: {cells} cells × n_max={n_max}, obs spec "
              f"'{obs_spec}' ({cfg.spec().dim} features), {epochs} epochs "
              f"in {n_stages} stages ("
              + (f"curriculum 2→{n_max}" if curriculum else "fixed fleet")
              + f") on {dev}")

    chunks = []
    synchronize(dev)
    t_last = time.perf_counter()

    def on_stage(s, scn, state, m):
        nonlocal t_last
        now = time.perf_counter()
        hist = history_to_dict(m)
        chunks.append(dict(stage=s, epochs=len(hist["epoch"]),
                           seconds=now - t_last, metrics=hist))
        t_last = now
        if verbose:
            print(f"stage {s + 1}/{n_stages}: epochs {hist['epoch'][0]}–"
                  f"{hist['epoch'][-1]}, users ≤ "
                  f"{int(scn.n_users.max())}, mean_r "
                  f"{hist['mean_reward'][-1]:.4f}, eps "
                  f"{hist['epsilon'][-1]:.3f}, real_steps "
                  f"{hist['real_steps'][-1]:,} "
                  f"({chunks[-1]['seconds']:.2f} s)")

    t0 = time.perf_counter()
    state = run_curriculum(trainer, stages, epochs, chunk, k_init, on_stage)
    train_s = time.perf_counter() - t0
    real_steps = int(state.real_steps)
    if verbose:
        print(f"\ntrained in {train_s:.1f} s — {real_steps:,} real "
              f"interactions ({real_steps / train_s:,.0f} steps/s)")
        if shared_cloud or shared_edge:
            print("note: the solver optimum is per-cell (it ignores the "
                  "couplings), so it is a lower bound and the gap below is "
                  "inflated")

    def evaluate(name, scn):
        t = time.perf_counter()
        opt = optimal_rewards(scn)
        solver_s = time.perf_counter() - t
        ev = evaluate_vs_solver(state.dqn.params, scn, cfg, key=k_eval,
                                opt_reward=opt)
        if verbose:
            print(f"{name}: mean reward {ev['mean_policy_reward']:.4f} vs "
                  f"optimal {ev['mean_opt_reward']:.4f} (gap "
                  f"{ev['mean_reward_gap']:.1%}, violations "
                  f"{ev['violation_rate']:.1%})")
        return ev, solver_s

    final, final_solver_s = evaluate("final stage fleet", stages[-1])
    held = random_fleet(rnd.PRNGKey(seed + 1234, dev), cells, n_max=n_max,
                        cells_per_edge=cells_per_edge)
    held_out, held_solver_s = evaluate("held-out fleet  ", held)
    if ckpt:
        save_bundle(ckpt, PolicyBundle(
            kind="dqn", obs_spec=obs_spec, n_max=n_max,
            params=state.dqn.params,
            meta={"algo": "HL", "trainer": "hltrain-fleet",
                  "cells": cells, "epochs": epochs,
                  "curriculum": bool(curriculum),
                  "shared_cloud": bool(shared_cloud),
                  "shared_edge": bool(shared_edge),
                  "cells_per_edge": int(cells_per_edge),
                  "held_out_violation_rate": float(
                      held_out["violation_rate"]),
                  "system": state.sm.params.to_layers()}))
        if verbose:
            print(f"saved PolicyBundle → {ckpt} (dqn, spec {obs_spec!r}, "
                  f"n_max={n_max})")
    return dict(state=state, stages=stages, held=held, chunks=chunks,
                train_seconds=train_s, real_steps=real_steps,
                solver_seconds=dict(final=final_solver_s,
                                    held_out=held_solver_s),
                final=final, held_out=held_out, hp=hp, cfg=cfg)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--algo", choices=("HL", "DQL", "QL"), default="HL")
    ap.add_argument("--users", type=int, default=5)
    ap.add_argument("--scenario", choices="ABCD", default="A")
    ap.add_argument("--constraint", choices=tuple(CONSTRAINTS),
                    default="89%")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--max-steps", type=int, default=None)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--fleet", action="store_true",
                    help="train on a vectorized fleet via hltrain")
    ap.add_argument("--cells", type=int, default=256)
    ap.add_argument("--n-max", type=int, default=8)
    ap.add_argument("--epochs", type=int, default=60)
    ap.add_argument("--chunk", type=int, default=5,
                    help="epochs per curriculum stage / run call")
    ap.add_argument("--no-curriculum", dest="curriculum",
                    action="store_false",
                    help="train on one fixed random fleet instead of the "
                         "2→n_max user-count curriculum")
    ap.add_argument("--shared-cloud", action="store_true",
                    help="couple cells through a shared cloud pool")
    ap.add_argument("--shared-edge", action="store_true",
                    help="couple co-located cells through shared edge "
                         "servers (see --cells-per-edge)")
    ap.add_argument("--cells-per-edge", type=int, default=1,
                    help="cells co-located per edge server group")
    ap.add_argument("--obs-spec", choices=SPEC_NAMES, default="base",
                    help="observation spec variant")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if not args.fleet:
        return train_single(algo=args.algo, users=args.users,
                            scenario=args.scenario,
                            constraint=args.constraint, seed=args.seed,
                            max_steps=args.max_steps, ckpt=args.ckpt,
                            device=args.device)
    if args.algo != "HL":
        ap.error("--fleet currently supports --algo HL only")
    if args.shared_edge and args.cells_per_edge <= 1:
        ap.error("--shared-edge needs --cells-per-edge > 1: with one cell "
                 "per edge server every group is a singleton and the "
                 "coupling is identically zero")
    return train_fleet(cells=args.cells, n_max=args.n_max,
                       epochs=args.epochs, chunk=args.chunk,
                       curriculum=args.curriculum, obs_spec=args.obs_spec,
                       shared_cloud=args.shared_cloud,
                       shared_edge=args.shared_edge,
                       cells_per_edge=args.cells_per_edge, seed=args.seed,
                       ckpt=args.ckpt, device=args.device)


if __name__ == "__main__":
    main()
