"""SN-Train (paper Sec. 3) in PyTorch: build, sweeps, streaming, fusion,
serving; the generic SOP machinery (``sop``) and SOP-consensus gossip over
``torch.distributed`` (``consensus``)."""

from . import (
    centralized,
    consensus,
    faults,
    fusion,
    kernels_math,
    monitor,
    plans,
    pruning,
    serving,
    sn_train,
    sop,
    streaming,
    topology,
)
from .centralized import KRRModel, fit_krr, predict
from .faults import FaultModel, faulty_sweep, make_fault_model
from .kernels_math import Kernel
from .monitor import WatchdogConfig, WatchdogReceipt, watch_sweeps
from .plans import LifecycleLayout
from .pruning import (
    PruneReport,
    answer_bound,
    prune_mask,
    prune_plan,
    representer_energy,
)
from .serving import (
    ServingPlan,
    make_serving_plan,
    plan_add_sensor,
    plan_remove_sensor,
)
from .sn_train import (
    SNTrainProblem,
    SNTrainState,
    colored_sweep,
    default_lambdas,
    effective_coef,
    field_view,
    init_state,
    local_only,
    make_batch_problem,
    make_problem,
    random_sweep,
    robust_sweep,
    robust_sweep_links,
    serial_sweep,
    sharded_sweep,
    weighted_norm_sq,
    weighted_norm_sq_hetero,
    weighted_sweep,
)
from .streaming import (
    AbsorbReceipt,
    JoinReceipt,
    absorb_wave,
    add_sensor,
    remove_sensor,
)
from .topology import (
    SensorTopology,
    build_topology,
    pad_topology,
    ring_topology,
    uniform_sensors,
)
