"""User-defined functions for warpdb_tpu queries.

JAX analogue of the reference's ``custom.cu`` (README.md:99-118):
drop JAX-traceable functions here and call them from query expressions,
e.g. ``warpdb_tpu "discount(price, 0.9)"``.  Functions receive float32
arrays (or scalars) and must return an array broadcastable to the row
count.  Pallas kernels are fine too — anything callable under jax.jit.
"""


def discount(price, rate):
    return price * rate
