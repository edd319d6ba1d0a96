"""Distribution: partition specs per architecture + sequence parallelism."""
from repro_torch.sharding import partition, sequence_parallel

__all__ = ["partition", "sequence_parallel"]
