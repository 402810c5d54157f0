"""Parallelism over the (data, heads) mesh (``nsa_tpu/parallel/``): the mesh
and its process groups (``mesh.py``), the collectives the model calls
(``comm.py``), the partition table (``sharding.py``) and the sharded
training step with its dry run (``train_step.py``)."""
