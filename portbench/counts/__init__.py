"""The work a kernel or a whole call, step or observation needs, counted
from the cell's shapes, and the card's published peaks.

Counted by one rule: each input read once, each
output written once, and the operations these inputs need, whatever
implements them (recomputation under remat, or a second pass over a
tensor, adds nothing). Each elementwise arithmetic operation, comparison
or transcendental counts as one operation, a multiply-add of a matrix
product as two. The roofline and `mfu` metrics divide by these counts,
so they read the same work whatever the port does inside.
"""
