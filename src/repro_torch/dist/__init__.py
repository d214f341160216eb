"""repro_torch.dist — the multi-device layer under the model, training and
serving paths (port of ``repro.dist``).

Three modules:

* ``sharding``     — logical-axis -> mesh-axis assignment (``Rules``), their
                     DTensor placements, the ``use_rules`` context,
                     ``constrain`` annotations, and the ParamSpec-tree
                     derivations (``abstract_state`` / ``param_shardings``)
                     the trainer consumes.
* ``collectives``  — the int8 wire codec, error feedback, and the compressed
                     all-reduce for cross-pod gradient traffic.
* ``flash_decode`` — distributed flash decoding: a log-sum-exp merge over a
                     sequence-sharded KV cache (the ``serve_seqkv`` preset),
                     each shard through the decode kernel's stats entry.

The JAX package's fourth module, ``compat``, shims JAX API names across JAX
versions; the port runs on PyTorch's own API and has no counterpart.

Importing this package starts no process group and no thread: a mesh is
made by ``repro_torch.launch.mesh`` over a world the caller starts.
"""
