"""secp256k1 ECDSA: the native curve and verification in a circuit."""
