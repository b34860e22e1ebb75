"""The Paddle tensor core of the port: ``Tensor`` over ``torch.Tensor``,
the dtype names, and the autograd surface over torch autograd."""
