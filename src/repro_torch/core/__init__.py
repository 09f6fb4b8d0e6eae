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
from .serving import ServingPlan, make_serving_plan
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
    serial_sweep,
    weighted_norm_sq,
)
from .streaming import AbsorbReceipt, absorb_wave
from .topology import (
    SensorTopology,
    build_topology,
    pad_topology,
    ring_topology,
    uniform_sensors,
)
