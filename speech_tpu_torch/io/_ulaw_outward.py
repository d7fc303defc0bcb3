"""sph2pipe's u-law bitshift-fixup lookup table (format data, not code).

``ULAW_OUTWARD[bitshift][value + 128]`` maps a shorten-decoded TYPE_AU1/AU2
sample value back to a u-law byte for a given bitshift.  This 13x256 uint8
table is a constant of the NIST SPHERE "shorten" format as implemented by the
LDC's sph2pipe tool (and the reference implementation derived from it); it is
embedded here verbatim as data because no closed-form generator reproduces it
exactly.  u-law/A-law <-> PCM tables, by contrast, are generated from the
G.711 formulas in ``speech_tpu_torch.io.sphere``.
"""

import base64

import numpy as np

_B64 = (
    "fwABAgMEBQYHCAkKCwwNDg8QERITFBUWFxgZGhscHR4fICEiIyQlJicoKSorLC0uLzAxMjM0"
    "NTY3ODk6Ozw9Pj9AQUJDREVGR0hJSktMTU5PUFFSU1RVVldYWVpbXF1eX2BhYmNkZWZnaGlq"
    "a2xtbm9wcXJzdHV2d3h5ent8fX7//v38+/r5+Pf29fTz8vHw7+7t7Ovq6ejn5uXk4+Lh4N/e"
    "3dzb2tnY19bV1NPS0dDPzs3My8rJyMfGxcTDwsHAv769vLu6ubi3trW0s7KxsK+urayrqqmo"
    "p6alpKOioaCfnp2cm5qZmJeWlZSTkpGQj46NjIuKiYiHhoWEg4KBgHBydHZ4enx+fwABAgME"
    "BQYHCAkKCwwNDg8QERITFBUWFxgZGhscHR4fICEiIyQlJicoKSorLC0uLzAxMjM0NTY3ODk6"
    "Ozw9Pj9AQUJDREVGR0hJSktMTU5PUFFSU1RVVldYWVpbXF1eX2BhYmNkZWZnaGlqa2xtbm9x"
    "c3V3eXt9//37+ff18/Hv7u3s6+rp6Ofm5eTj4uHg397d3Nva2djX1tXU09LR0M/OzczLysnI"
    "x8bFxMPCwcC/vr28u7q5uLe2tbSzsrGwr66trKuqqainpqWko6KhoJ+enZybmpmYl5aVlJOS"
    "kZCPjo2Mi4qJiIeGhYSDgoGA/vz6+Pb08vBgYmRmaGpsbnBxcnR1dnh5enx9fn8AAQIDBAUG"
    "BwgJCgsMDQ4PEBESExQVFhcYGRobHB0eHyAhIiMkJSYnKCkqKywtLi8wMTIzNDU2Nzg5Ojs8"
    "PT4/QEFCQ0RFRkdISUpLTE1OT1BRUlNUVVZXWFlaW1xdXl9hY2VnaWttb3N3e//79/Pv7evp"
    "5+Xj4d/e3dzb2tnY19bV1NPS0dDPzs3My8rJyMfGxcTDwsHAv769vLu6ubi3trW0s7KxsK+u"
    "rayrqqmop6alpKOioaCfnp2cm5qZmJeWlZSTkpGQj46NjIuKiYiHhoWEg4KBgP79/Pr5+Pb1"
    "9PLx8O7s6ujm5OLgUFJUVlhaXF5gYWJkZWZoaWpsbW5wcXJzdHV2eHl6e3x9fn8AAQIDBAUG"
    "BwgJCgsMDQ4PEBESExQVFhcYGRobHB0eHyAhIiMkJSYnKCkqKywtLi8wMTIzNDU2Nzg5Ojs8"
    "PT4/QEFCQ0RFRkdISUpLTE1OT1FTVVdZW11fY2drb3f/9+/r5+Pf3dvZ19XT0c/OzczLysnI"
    "x8bFxMPCwcC/vr28u7q5uLe2tbSzsrGwr66trKuqqainpqWko6KhoJ+enZybmpmYl5aVlJOS"
    "kZCPjo2Mi4qJiIeGhYSDgoGA/v38+/r5+Pb19PPy8fDu7ezq6ejm5eTi4eDe3NrY1tTS0EBC"
    "REZISkxOUFFSVFVWWFlaXF1eYGFiY2RlZmhpamtsbW5wcXJzdHV2d3h5ent8fX5/AAECAwQF"
    "BgcICQoLDA0ODxAREhMUFRYXGBkaGxwdHh8gISIjJCUmJygpKissLS4vMDEyMzQ1Njc4OTo7"
    "PD0+P0FDRUdJS01PU1dbX2dv/+/n39vX08/Ny8nHxcPBv769vLu6ubi3trW0s7KxsK+urayr"
    "qqmop6alpKOioaCfnp2cm5qZmJeWlZSTkpGQj46NjIuKiYiHhoWEg4KBgP79/Pv6+fj39vX0"
    "8/Lx8O7t7Ovq6ejm5eTj4uHg3t3c2tnY1tXU0tHQzszKyMbEwsAxMzU3OTs9P0BCQ0RGR0hK"
    "S0xOT1BRUlRVVldYWVpcXV5fYGFiY2RlZmhpamtsbW5vcHFyc3R1dnd4eXp7fH1+fwABAgME"
    "BQYHCAkKCwwNDg8QERITFBUWFxgZGhscHR4fICEiIyQlJicoKSorLC0uLzAyNDY4Ojw+QUVJ"
    "TVNbZ//n29PNycXBvry6uLa0srCvrq2sq6qpqKempaSjoqGgn56dnJuamZiXlpWUk5KRkI+O"
    "jYyLiomIh4aFhIOCgYD+/fz7+vn49/b19PPy8fDv7u3s6+rp6Obl5OPi4eDf3t3c2tnY19bV"
    "1NLR0M/OzMvKyMfGxMPCwL+9u7m3tbOxICIkJigqLC4wMTM0NTc4OTs8PT9AQUJDREZHSElK"
    "S0xOT1BRUlNUVVZXWFlaXF1eX2BhYmNkZWZnaGlqa2xtbm9wcXJzdHV2d3h5ent8fX5/AAEC"
    "AwQFBgcICQoLDA0ODxAREhMUFRYXGBkaGxwdHh8hIyUnKSstLzI2Oj5FTVv/283Fvrq2sq+t"
    "q6mnpaOhn56dnJuamZiXlpWUk5KRkI+OjYyLiomIh4aFhIOCgYD+/fz7+vn49/b19PPy8fDv"
    "7u3s6+rp6Ofm5eTj4uHg397d3NrZ2NfW1dTT0tHQz87My8rJyMfGxMPCwcC/vby7ubi3tbSz"
    "sbCurKqopqSioBASFBYYGhweICEiJCUmKCkqLC0uMDEyMzQ1Nzg5Ojs8PT9AQUJDREVGR0hJ"
    "SktMTk9QUVJTVFVWV1hZWltcXV5fYGFiY2RlZmdoaWprbG1ub3BxcnN0dXZ3eHl6e3x9fn8A"
    "AQIDBAUGBwgJCgsMDQ4PERMVFxkbHR8jJysvNj5N/82+tq+rp6OfnZuZl5WTkY+OjYyLiomI"
    "h4aFhIOCgYD+/fz7+vn49/b19PPy8fDv7u3s6+rp6Ofm5eTj4uHg397d3Nva2djX1tXU09LR"
    "0M/OzMvKycjHxsXEw8LBwL+9vLu6ubi3tbSzsrGwrq2sqqmopqWkoqGgnpyamJaUkpACBAYI"
    "CgwOEBESFBUWGBkaHB0eICEiIyQlJigpKissLS4wMTIzNDU2Nzg5Ojs8PT9AQUJDREVGR0hJ"
    "SktMTU5PUFFSU1RVVldYWVpbXF1eX2BhYmNkZWZnaGlqa2xtbm9wcXJzdHV2d3h5ent8fX5/"
    "AAEDBQcJCw0PExcbHycvPv++r6efm5eTj42LiYeFg4H+/fz7+vn49/b19PPy8fDv7u3s6+rp"
    "6Ofm5eTj4uHg397d3Nva2djX1tXU09LR0M/OzczLysnIx8bFxMPCwcC/vby7urm4t7a1tLOy"
    "sbCurayrqqmopqWko6KhoJ6dnJqZmJaVlJKRkI6MioiGhIKAAQIEBQYICQoMDQ4QERITFBUW"
    "GBkaGxwdHiAhIiMkJSYnKCkqKywtLjAxMjM0NTY3ODk6Ozw9Pj9AQUJDREVGR0hJSktMTU5P"
    "UFFSU1RVVldYWVpbXF1eX2BhYmNkZWZnaGlqa2xtbm9wcXJzdHV2d3h5ent8fX5/AAMHCw8X"
    "Hy//r5+Xj4uHg/79/Pv6+fj39vX08/Lx8O/u7ezr6uno5+bl5OPi4eDf3t3c29rZ2NfW1dTT"
    "0tHQz87NzMvKycjHxsXEw8LBwL++vby7urm4t7a1tLOysbCurayrqqmop6alpKOioaCenZyb"
    "mpmYlpWUk5KRkI6NjIqJiIaFhIKBgAECAwQFBggJCgsMDQ4QERITFBUWFxgZGhscHR4gISIj"
    "JCUmJygpKissLS4vMDEyMzQ1Njc4OTo7PD0+P0BBQkNERUZHSElKS0xNTk9QUVJTVFVWV1hZ"
    "WltcXV5fYGFiY2RlZmdoaWprbG1ub3BxcnN0dXZ3eHl6e3x9fn8ABw8f/5+Ph/79/Pv6+fj3"
    "9vX08/Lx8O/u7ezr6uno5+bl5OPi4eDf3t3c29rZ2NfW1dTT0tHQz87NzMvKycjHxsXEw8LB"
    "wL++vby7urm4t7a1tLOysbCvrq2sq6qpqKempaSjoqGgnp2cm5qZmJeWlZSTkpGQjo2Mi4qJ"
    "iIaFhIOCgYABAgMEBQYHCAkKCwwNDhAREhMUFRYXGBkaGxwdHh8gISIjJCUmJygpKissLS4v"
    "MDEyMzQ1Njc4OTo7PD0+P0BBQkNERUZHSElKS0xNTk9QUVJTVFVWV1hZWltcXV5fYGFiY2Rl"
    "ZmdoaWprbG1ub3BxcnN0dXZ3eHl6e3x9fn8AD/+P/v38+/r5+Pf29fTz8vHw7+7t7Ovq6ejn"
    "5uXk4+Lh4N/e3dzb2tnY19bV1NPS0dDPzs3My8rJyMfGxcTDwsHAv769vLu6ubi3trW0s7Kx"
    "sK+urayrqqmop6alpKOioaCfnp2cm5qZmJeWlZSTkpGQjo2Mi4qJiIeGhYSDgoGAAQIDBAUG"
    "BwgJCgsMDQ4PEBESExQVFhcYGRobHB0eHyAhIiMkJSYnKCkqKywtLi8wMTIzNDU2Nzg5Ojs8"
    "PT4/QEFCQ0RFRkdISUpLTE1OT1BRUlNUVVZXWFlaW1xdXl9gYWJjZGVmZ2hpamtsbW5vcHFy"
    "c3R1dnd4eXp7fH1+fwD//v38+/r5+Pf29fTz8vHw7+7t7Ovq6ejn5uXk4+Lh4N/e3dzb2tnY"
    "19bV1NPS0dDPzs3My8rJyMfGxcTDwsHAv769vLu6ubi3trW0s7KxsK+urayrqqmop6alpKOi"
    "oaCfnp2cm5qZmJeWlZSTkpGQj46NjIuKiYiHhoWEg4KBgA=="
)

ULAW_OUTWARD = np.frombuffer(
    base64.b64decode("".join(_B64)), dtype=np.uint8
).reshape(13, 256)
