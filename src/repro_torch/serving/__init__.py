from .engine import IO_SUMMARY_KEYS, ServeEngine, StepStats
from .kv_pool import KVPagePool, KVPoolExhausted, prompt_prefix_hashes
from .request import PoissonArrivalDriver, Request, RequestState
from .scheduler import Scheduler, SchedulerStats
from .sparse_exec import SERVE_METHODS, SPARSE_METHODS, WBITS_CHOICES, SparseExecution
