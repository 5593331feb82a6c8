from repro_torch.workflows.generators import (  # noqa: F401
    Workflow,
    WORKFLOW_KINDS,
    independent_tasks,
    layered_random,
    make_workflow,
    wfgen_scale,
)
