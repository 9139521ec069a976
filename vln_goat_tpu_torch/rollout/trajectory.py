"""Host-side trajectory postprocessing: recorded rollout outputs ->
predicted viewpoint paths / visualization JSON (GraphMap.save_to_json,
models/graph_utils.py:146-164; submission paths agent_base.py:28-34).

A copy of vln_goat_tpu/rollout/trajectory.py (numpy only)."""
from typing import Dict

import numpy as np


def trajectory_to_json(batch_np: Dict[str, np.ndarray],
                       out_np: Dict[str, np.ndarray], b: int,
                       vp_ids=None) -> dict:
    """Episode graph dump for visualization (GraphMap.save_to_json,
    models/graph_utils.py:146-164): nodes with visited flags + stop probs,
    the predicted path, and the chosen stop node."""
    node_vp = out_np["node_vp"][b]
    n = int(out_np["n_nodes"][b])
    nodes = {}
    paths = assemble_trajectories(batch_np, out_np)
    for i in range(n):
        vp = int(node_vp[i])
        name = vp_ids[vp] if vp_ids is not None else str(vp)
        nodes[name] = {"visited": vp in paths[b]}
    stop_vp = int(node_vp[out_np["stop_node"][b]])
    return {
        "nodes": nodes,
        "path": [vp_ids[v] if vp_ids is not None else v for v in paths[b]],
        "stop_node": vp_ids[stop_vp] if vp_ids is not None else stop_vp,
    }


def assemble_trajectories(batch_np: Dict[str, np.ndarray],
                          out_np: Dict[str, np.ndarray],
                          include_backtrack: bool = True) -> list:
    """Host-side: recorded segments -> predicted paths of local vp ids
    (list of lists, matching traj[i]['path'] flattened).  Step segments
    already carry vp ids (recorded pre-arrive, spill-safe); the final
    backtrack is slot-based and decoded through the final node table
    (safe: no arrivals happen after it)."""
    T, B, P = out_np["segs"].shape
    node_vp = out_np["node_vp"]
    paths = []
    for b in range(B):
        path = [int(batch_np["start_vp"][b])]
        for t in range(T):
            hops = int(out_np["seg_hops"][t, b])
            for i in range(min(hops, P)):
                v = out_np["segs"][t, b, i]
                if v < 0:
                    break
                path.append(int(v))
        if include_backtrack:
            hops = int(out_np["back_hops"][b])
            for i in range(min(hops, out_np["back_seg"].shape[1])):
                n = out_np["back_seg"][b, i]
                if n < 0:
                    break
                path.append(int(node_vp[b, n]))
        paths.append(path)
    return paths
