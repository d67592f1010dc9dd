"""The CNF map, ``ContinuousEGNNMap``, on a 32-atom chain of four types.

The frames are the helix of ``cnf_egnn32.json`` with Gaussian noise, drawn
on the device from the run's seed; the program receives them as a
``System`` on the host. The pairwise block runs through the fused kernels (K4 forward with
the probe's tangent, K5 backward); the target is harmonic.
"""

from __future__ import annotations

import numpy as np
import torch

from tfep_bench.molecules import helix_frames
from tfep_bench.targets import HarmonicPotential


def frames(cfg, n, seed, device):
    """``(n, 3 n_atoms)`` float32 frames on ``device`` from the seed."""
    return helix_frames(cfg, n, seed, device)


def build_map(cfg, traffic, host_frames, device, logger_dir=None):
    """The program's map over ``host_frames``, not yet set up; it logs
    the work values under ``logger_dir`` if one is given."""
    from tfep_tpu_torch.app import ContinuousEGNNMap
    from tfep_tpu_torch.io.topology import Topology
    from tfep_tpu_torch.io.traj import System
    from tfep_tpu_torch.units import ureg

    n = int(cfg['n_atoms'])
    system = System(Topology(names=[f'C{i}' for i in range(n)]),
                    host_frames.reshape(len(host_frames), n, 3))
    batch = traffic.get('batch', traffic.get('eval_batch'))
    return ContinuousEGNNMap(
        potential_energy_func=HarmonicPotential(cfg['temperature_K']),
        temperature=cfg['temperature_K'] * ureg.kelvin, system=system,
        batch_size=int(batch), tfep_logger_dir_path=logger_dir,
        node_types=list(np.arange(n) % int(cfg['n_types'])),
        r_cutoff=cfg['r_cutoff'], n_egnn_layers=cfg['n_egnn_layers'],
        node_feat_dim=cfg['node_feat_dim'],
        distance_feat_dim=cfg['distance_feat_dim'],
        time_feat_dim=cfg['time_feat_dim'], solver=cfg['solver'],
        n_steps=cfg['ode_steps'], trace_estimator=cfg['trace_estimator'],
        n_hutchinson_samples=cfg['n_hutchinson_samples'],
        regularization=cfg['regularization'],
        egnn_kwargs={'pairwise': cfg['pairwise']},
        cnf_kwargs={'checkpoint': cfg['checkpoint']},
        seed=int(cfg['map_seed']), device=device,
        dtype=getattr(torch, cfg['dtype']))


_LAYER = {'radial.log_gammas': 'distance_embedding.log_gammas_param',
          'msg0': 'message_mlp.layers.0', 'msg1': 'message_mlp.layers.1',
          'att': 'attention_mlp.layers.0', 'x0': 'update_x_mlp.layers.0',
          'x1': 'update_x_mlp.layers.1', 'h0': 'update_h_mlp.layers.0',
          'h1': 'update_h_mlp.layers.1'}


def port_name(key):
    """The program's name of a reference weight."""
    if key == 'time.log_gammas':
        return 'dynamics.time_embedding.log_gammas_param'
    if key.startswith('embed.'):
        return 'dynamics.h_embedding.' + key.split('.')[1]
    layer, rest = key.split('.', 1)
    if rest in _LAYER:
        return f'dynamics.graph_layers.{layer[1:]}.{_LAYER[rest]}'
    module, leaf = rest.rsplit('.', 1)
    return f'dynamics.graph_layers.{layer[1:]}.{_LAYER[module]}.{leaf}'
