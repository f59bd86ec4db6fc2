"""Circuits the port builds: the flagship hash tree and the fibonacci example."""
