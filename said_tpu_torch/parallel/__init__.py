"""Data- and sequence-parallel execution over ``torch.distributed``.

Port of ``said_tpu.parallel``: ``mesh`` lays the ranks out as the JAX
package's ('data', 'model', 'seq') mesh and builds a process group for an
axis; ``seq`` holds the frame-axis collectives (shard, gather, halo) that
GSPMD writes for the JAX package. The sharded draws of ``mesh`` make N
ranks draw the random numbers one process would.
"""
