"""The benchmark of seaweedfs_tpu_torch: EC encode of sealed volumes
through the port's shard pipeline on one CUDA card.

run.py runs one cell once; registry.py finds cells, configurations, ops
and metric readers by name; harness.py drives the window and the check;
ops/encode.py is the encode op; reference.py is the plain Reed-Solomon
coder the check holds the program against; volumes.py makes the seeded
volumes; trace.py reduces the device trace; control.py runs the control. Nothing here imports JAX or the JAX
package, and reference.py imports nothing of the program.
"""
