"""Operations and bytes of each operation the cells run, from shapes
alone: the work of the operation, not of the code that carries it."""
