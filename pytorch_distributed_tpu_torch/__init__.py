"""PyTorch + CUDA port of ``pytorch_distributed_tpu`` for one NVIDIA H100.

The JAX package beside this one is the reference; every module here names
the reference module it replaces.  This package imports ``torch``, never
``jax`` and nothing of ``pytorch_distributed_tpu``: the framework-free
pieces it needs (config, transition schema, the Pong simulator, n-step
assembly, clocks, the parameter store) are its own copies.

Slice 1 runs CONFIGS row 12 (``dqn/pong-sim/device-per/dqn-cnn``) end to
end: actors step the numpy Pong simulator, the learner owns a prioritized
ring in device memory, and each learner dispatch runs K sub-steps of
sample -> forward/backward -> Adam -> target update -> priority
write-back.  Both TPU kernels of that learner are hand-written Hopper
kernels here (``csrc/per_sample.cu``; the torso GEMM as
``csrc/torso_gemm_sm90.cu`` forward and ``csrc/torso_gemm.cu`` backward).

Entry point::

    python -m pytorch_distributed_tpu_torch.main --config 12 --backend thread
"""
