"""Weight bridge from JAX-layout numpy pytrees to torch tensors."""
