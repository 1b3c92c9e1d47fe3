"""The sharded paths of the port on ``torch.distributed`` (counterpart of
``diffsptk_tpu/parallel/``): one process per device, a (dp, tp)
``DeviceMesh``, and classes that take and return each rank's block.
Not imported by the package's ``__init__``: ``import
diffsptk_tpu_torch.parallel``."""

from .filters import ShardedAllPoleDigitalFilter
from .halo import exchange_halo
from .learners import DataParallelGMM
from .mesh import make_mesh, shard, unshard
from .sharded import ShardedSTFT, sharded_frame
from .vocoder import ShardedMelCepstralVocoder
from .world import ShardedWorldVocoder
