"""The PLONK layer of the port: circuit shape, constraint programs, quotient."""
