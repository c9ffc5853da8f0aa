from .engine import IO_SUMMARY_KEYS, ServeEngine, StepStats
from .sparse_exec import SERVE_METHODS, SPARSE_METHODS, WBITS_CHOICES, SparseExecution
