from . import fasta
from . import readstore
