"""Plain references the benchmark judges the program's answers against.

Each module works out its answers from the tables the benchmark made,
with plain torch operations on whatever device it is given; none imports
anything of the program (a test holds that).
"""
