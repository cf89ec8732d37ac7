"""The decentralized federated learning round engine."""
