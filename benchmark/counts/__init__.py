"""Operation and byte counts of the work a configuration needs, frozen here.

`peaks.py` holds the card's published peaks and the least-time rule;
`<kind>.py` counts one model kind's work at a cell's shapes (a new kind adds
its file). The counts are copies of the arithmetic that the program's
kernel modules keep beside each kernel (`bound()`), taken here so that a
kernel's roofline reads the same work whatever later implements it.
"""
