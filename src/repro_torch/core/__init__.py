"""SN-Train (paper Sec. 3) in PyTorch: build, sweeps, streaming, fusion, serving."""

from . import (
    centralized,
    fusion,
    kernels_math,
    plans,
    serving,
    sn_train,
    streaming,
    topology,
)
from .centralized import KRRModel, fit_krr, predict
from .kernels_math import Kernel
from .plans import LifecycleLayout
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
    robust_sweep,
    serial_sweep,
    weighted_norm_sq,
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
