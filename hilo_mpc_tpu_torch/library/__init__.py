from .models import (cstr_schaffner_and_zeitz, cstr_seborg, ecoli_D1210_conti,
                     ecoli_D1210_fedbatch, scerevisiae_SEY2102_fedbatch)
