"""LoopTune core, ported to PyTorch: the loop-nest IR, cursor actions and
features, the reward backends (analytical TPU model, NumPy interpreter and
the card executor), the vectorised environment, the policy networks and
encoders, the DQN, APEX-DQN, PPO, A2C and IMPALA trainers, the learned
surrogate, the traditional searches and the :class:`LoopTuner` that
persists tuned schedules for the kernel layer; and the measurement fleet:
the worker pool, the kernel store and the measurement farm.
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
from .a2c import A2CConfig, train_a2c
from .apex_dqn import ApexConfig, train_apex
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
from .dqn import DQNConfig, train_dqn
from .encoders import (
    EncoderConfig,
    FlatEncoder,
    GraphEncoder,
    Network,
    build_network,
    checkpoint_meta,
    get_encoder,
    make_policy_act,
    make_score_fn,
    register_encoder,
)
from .env import LoopTuneEnv
from .features import MAX_LOOPS, STATE_DIM, encode, normalize, stride_bin
from .impala import ImpalaConfig, train_impala, vtrace
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
from .kernel_store import PersistentKernelStore, open_store
from .measure import (
    MeasuredBackend,
    Measurement,
    MeasurementPolicy,
    PerWorker,
    WorkerPool,
    measure_local,
    measure_settings,
    measurement_of,
)
from .measure_service import (
    FarmUnavailableError,
    MeasureServer,
    RemoteMeasuredBackend,
    RemoteMeasureError,
)
from .networks import (
    MASK_SENTINEL,
    masked_argmax,
    masked_fill,
    masked_logits,
    params_from_numpy,
    params_to_numpy,
)
from .ppo import PPOConfig, gae, train_ppo
from .registry import ScheduleRegistry, card_boundary, schedule_to_blockspec
from .replay import PrioritizedReplay, ReplayBuffer, SumTree
from .rl_common import (
    TrainResult,
    collect_vec_rollout,
    epsilon_greedy_batch,
    epsilon_ladder,
    evaluate_policy,
    greedy_rollout,
    greedy_rollout_vec,
    load_checkpoint,
    load_params,
    make_masked_act,
    sample_masked,
)
from .schedule_cache import LRUCache, ScheduleCache
from .search import (
    SEARCHES,
    SearchResult,
    beam_search,
    greedy_search,
    random_search,
    run_all_searches,
)
from .surrogate import (
    SurrogateDataset,
    SurrogateModel,
    SurrogateScorer,
    make_surrogate,
)
from .torch_backend import (
    CompiledKernelCache,
    TorchBackend,
    execute_torch,
    match_kernel_route,
    register_kernel_route,
)
from .tuner import LoopTuner, load_policy, make_act_from_checkpoint
from .vec_env import VecLoopTuneEnv

__all__ = [k for k in dir() if not k.startswith("_")]
