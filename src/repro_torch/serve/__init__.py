from repro_torch.serve.batching import ContinuousBatcher, Request  # noqa: F401
from repro_torch.serve.journal import (  # noqa: F401
    TicketJournal,
    decode_ticket,
    encode_ticket,
)
from repro_torch.serve.service import (  # noqa: F401
    FALLBACK_CHAINS,
    InvalidRequest,
    Overloaded,
    PlanFailure,
    PlanService,
    ServiceClosed,
    ServiceError,
    Ticket,
    TicketCancelled,
)
