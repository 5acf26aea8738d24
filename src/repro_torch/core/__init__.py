"""LoopTune core, ported to PyTorch: the loop-nest IR, cursor actions and
features, the reward backends (analytical TPU model, NumPy interpreter and
the card executor), the traditional searches and the :class:`LoopTuner`
that persists tuned schedules for the kernel layer.

The trainers, the learned surrogate, the worker pool and the measurement
farm are not ported yet (ROADMAP.md).
"""
from .actions import (
    Action,
    CPU_SPLITS,
    TPU_SPLITS,
    apply_action,
    build_action_space,
    is_legal,
    legal_mask,
)
from .backend import (
    Backend,
    backend_name,
    make_backend,
    register_backend,
    registered_backends,
)
from .cost_model import TPUAnalyticalBackend
from .cpu_backend import CPUMeasuredBackend, execute, execute_reference, make_inputs
from .dataset import (
    DIMS,
    matmul_dataset,
    mixed_ops_dataset,
    small_dataset,
    train_test_split,
)
from .env import LoopTuneEnv
from .features import MAX_LOOPS, STATE_DIM, encode, normalize, stride_bin
from .graph_features import (
    GRAPH_MAX_LOOPS,
    N_EDGE_TYPES,
    FlatFeaturizer,
    GraphFeaturizer,
    LoopGraph,
    build_adjacency,
    encode_graph,
    packed_dim,
    unpack_graph,
)
from .loop_ir import (
    Contraction,
    LoopLevel,
    LoopNest,
    TensorSpec,
    conv2d_benchmark,
    matmul_benchmark,
    reduction_benchmark,
    transpose_benchmark,
)
from .measure import (
    MeasuredBackend,
    Measurement,
    MeasurementPolicy,
    measure_local,
    measure_settings,
    measurement_of,
)
from .registry import ScheduleRegistry, card_boundary, schedule_to_blockspec
from .schedule_cache import LRUCache, ScheduleCache
from .search import (
    SEARCHES,
    SearchResult,
    beam_search,
    greedy_search,
    random_search,
    run_all_searches,
)
from .torch_backend import (
    CompiledKernelCache,
    TorchBackend,
    execute_torch,
    match_kernel_route,
    register_kernel_route,
)
from .tuner import LoopTuner

__all__ = [k for k in dir() if not k.startswith("_")]
