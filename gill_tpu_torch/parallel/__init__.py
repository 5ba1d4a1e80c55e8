"""Data and tensor parallelism over torch.distributed (counterpart of
gill_tpu/parallel/).

gill_tpu lays its devices out as a ("data", "model") mesh and lets GSPMD
insert the collectives. Here every rank is one process and the
collectives are explicit:

  mesh.py         `init_distributed` (the process group from
                  torch.distributed.run's environment) and `create_mesh`
                  (the "data" and "model" groups of a row-major (dp, tp)
                  layout);
  collectives.py  Megatron's pair for the model-parallel region
                  (`copy_to_model`, `reduce_from_model`), the all-gather
                  over "data" with a sliced backward, and the reductions
                  the trainer, validation and meters use;
  partition.py    gill_tpu's `param_pspecs` rules, `shard_params` /
                  `gather_params`, batch splitting over "data" and
                  `gather_rows` (gill_tpu's `host_local_rows` + allgather);
  launch.py       `run_ranks`: a group of rank processes on one host with a
                  file store, a process-group timeout and a join limit.

The SPMD contract: every rank of a mesh calls the same functions with the
same replicated inputs, in the same order; each rank feeds its own rows
only where a function says so (the trainer's batch, validation's loader).
"""

from gill_tpu_torch.parallel.mesh import Mesh, create_mesh, init_distributed
from gill_tpu_torch.parallel.partition import param_pspecs, shard_params

__all__ = ["Mesh", "create_mesh", "init_distributed", "param_pspecs",
           "shard_params"]
