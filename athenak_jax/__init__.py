"""athenak_jax: an astrophysical fluid dynamics / numerical relativity
framework built from scratch in JAX/XLA.

Capability target: the AthenaK reference (C++17 + Kokkos + MPI).  The design
is array-first, not a translation:

  * MeshBlockPack state lives as batched ``[nmb, nvar, nx3c, nx2c, nx1c]``
    jnp arrays (ghost zones included) — the natural analogue of the
    reference's packed Kokkos Views (reference: src/mesh/meshblock_pack.hpp).
  * The per-cycle task list collapses to a single pure, jitted
    ``step(state) -> state`` function; XLA schedules what the reference's
    polling TaskList schedules by hand (reference: src/tasklist/task_list.hpp).
  * Ghost-zone exchange is a static block-axis gather (sequential per-axis
    sweeps fill edges/corners); across devices the explicit shard_map cycle
    ships halo slabs with ppermute, replacing MPI Isend/Irecv
    (reference: src/bvals/).
  * Reductions (dt, history) are plain jnp reductions that GSPMD turns into
    psum/pmin, replacing MPI_Allreduce (reference: src/mesh/mesh.cpp:636).
"""

__version__ = "0.1.0"
