"""PyTorch + CUDA port of the spiking temporal detector (H100 target).

The JAX package ``snn_object_detectionddp_tpu`` is the reference this port
is held against; the port imports nothing from it. Activations are
channels-last (NHWC, time-major ``(T*B, H, W, C)`` inside spiking blocks),
the same layout as the JAX package, so tests compare like with like.

Entry points run on ``device="cuda"`` unless the caller asks for the CPU.
On a CUDA tensor the normalize+LIF stage runs the hand-written kernels in
``csrc/affine_lif.cu`` (inference forward; under a gradient the
residual-saving forward and the surrogate-BPTT backward); on a CPU tensor
it runs the plain PyTorch versions. Serving is ``serve.py``; training is
``train/`` (``make_optimizer`` -> ``init_state`` -> ``make_step_fns`` ->
``train_loop``).
"""
