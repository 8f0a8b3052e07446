"""The plain reference the benchmark judges the program against. Imports
neither JAX nor anything of the program."""
