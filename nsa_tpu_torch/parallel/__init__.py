"""Parallelism (``nsa_tpu/parallel/``): the mesh and its process groups
(``mesh.py``), the collectives the model calls (``comm.py``), the
partition table (``sharding.py``), the sharded training step with its dry
run (``train_step.py``), context parallelism over a ``seq`` mesh
(``context.py``) and the weak-scaling benchmark (``scaling_bench.py``)."""
