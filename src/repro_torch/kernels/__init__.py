"""The port's CUDA kernels (``csrc/``), their wrappers, plain PyTorch
versions (``ref``) and the device dispatch (``ops``).  Importing this
package builds nothing: the library is compiled at its first launch."""
