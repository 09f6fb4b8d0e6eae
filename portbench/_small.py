"""Small shapes of the cells for the CPU tests: the same code paths at a size
a test run holds."""

from __future__ import annotations

from portbench import harness

CONFIGS = {"field-n1000": dict(n_sensors=60, radius=0.4, n_sweeps=3),
           "paper-case2-n50": dict(n_sensors=20, n_sweeps=4)}
TRAFFIC = {"train-b256": dict(fields=3, warm_calls=1, checked_calls=2, trace_items=2),
           "trials-b1024": dict(fields=3, warm_calls=1, checked_calls=2, trace_items=2),
           "knn-q4k-64k": dict(fields=3, sizes=dict(q_min=8, q_max=32, count=3),
                               checked_requests=2, trace_items=3),
           "conn-q4k-64k": dict(fields=3, sizes=dict(q_min=8, q_max=32, count=3),
                                checked_requests=2, trace_items=3)}


def small_cell(name: str, root=harness.ROOT, bench=None) -> harness.Cell:
    cell = harness.Cell.find(name, root=root, bench=bench)
    cell.config.update(CONFIGS.get(cell.workload["config"], {}))
    cell.traffic.update(TRAFFIC.get(cell.workload["traffic"], {}))
    return cell
