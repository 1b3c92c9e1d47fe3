from .recurrence import (
    first_order_recurrence,
    lfilter,
    sample_wise_lpc,
)
