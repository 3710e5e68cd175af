"""The plain reference that decides `correct`: NumPy and plain PyTorch,
independent of the program. It imports neither `jax` nor the JAX
package nor anything of the port, and takes nothing the program made
but the model it is judging."""
