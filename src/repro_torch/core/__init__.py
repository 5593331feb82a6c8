"""CaWoSched core of the port: the paper's contribution (scheduling on G_c)."""
from repro_torch.core.cawosched import (  # noqa: F401
    ALL_VARIANTS,
    VARIANTS_BY_NAME,
    ScheduleResult,
    Variant,
    deadline_from_asap,
)
from repro_torch.core.carbon import (  # noqa: F401
    PowerProfile,
    SCENARIOS,
    generate_profile,
    schedule_cost,
    schedule_cost_torch,
    validate_schedule,
)
from repro_torch.core.cancel import Cancelled, CancelToken  # noqa: F401
from repro_torch.core.dag import (  # noqa: F401
    FixedMapping,
    Instance,
    build_instance,
    trivial_mapping,
)
from repro_torch.core.estlst import (  # noqa: F401
    asap_schedule,
    compute_est,
    compute_lst,
    est_lst_torch,
    makespan,
)
from repro_torch.core.greedy_torch import (  # noqa: F401
    BlockedLP,
    LP_MAX_BYTES,
    longest_path_matrix,
    lp_block_bytes,
    lp_for,
    lp_matrix_bytes,
)
from repro_torch.core.heft import heft_mapping  # noqa: F401
from repro_torch.core.portfolio import (  # noqa: F401
    PORTFOLIO_VARIANTS,
    PreparedGraph,
    PreparedInstance,
    ProfileOverlay,
    overlay_profile,
    portfolio_cost_matrix,
    prepare_graph,
    robust_pick,
    schedule_portfolio_grid,
)
from repro_torch.core.solvers import (  # noqa: F401
    AsapSolver,
    DpUniprocSolver,
    ExactSolver,
    HeuristicSolver,
    IlpSolver,
    SolveOutput,
    Solver,
    get_solver,
    register_solver,
    solver_names,
)
