"""Data-, sequence- and tensor-parallel execution over ``torch.distributed``.

Port of ``said_tpu.parallel``: ``mesh`` lays the ranks out as the JAX
package's ('data', 'model', 'seq') mesh and builds a process group for an
axis; ``seq`` holds the collectives (shard, gather, halo, sums) that GSPMD
writes for the JAX package, each differentiable where training needs it;
``tensor`` splits parameters over the 'model' axis (the JAX
``shard_params``). The sharded draws of ``mesh`` make N ranks draw the
random numbers one process would.
"""
