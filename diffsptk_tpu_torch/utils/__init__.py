from . import checkpoint
from .linalg import (
    cas,
    cexp,
    clog,
    hankel,
    plateau,
    remove_gain,
    symmetric_toeplitz,
    vander,
)
from .profiling import Throughput, trace
from .scales import auditory_to_hz, hz_to_auditory
from .wavio import get_alpha, read, write
